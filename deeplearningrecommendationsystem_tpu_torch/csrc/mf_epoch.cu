// Full-batch MF training epochs for Hopper (sm_90a), with a plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernel deeplearningrecommendationsystem_tpu/ops/pallas/
// mf_epoch.py::mf_fullbatch_train (_kernel): a whole MF run of full-batch epochs,
// each one the gathers of both factor tables, the BCE loss, its one-hot backward
// and a torch-Adam step (L2 before the moments) on f32 master weights, with the
// forward and backward in float32 or bfloat16. Its plain PyTorch version is
// mf_fullbatch_train_plain in deeplearningrecommendationsystem_tpu_torch/ops/mf_epoch.py.
//
// The Pallas kernel keeps the tables and the Adam moments in VMEM across a grid
// (epochs, row_blocks) that the TPU runs in order. CUDA blocks run in no order,
// so each epoch is two launches on one stream, which orders them:
//
// mf_epoch_kernel: a warp takes 32 consecutive rows. For each row its lanes load
// the user's and the item's factors (lane l holds columns l, l + 32, ..., kCols
// of them: 4, 8 or 16, the fewest that cover D, so D <= 512; in the
// bf16 variant each master value is rounded to bf16 first, as the Pallas kernel's
// astype does), reduce the dot product z over the warp, and compute the stable
// BCE max(z, 0) - z y + log1p(exp(-|z|)) and g = (sigmoid(z) - y) / B. The
// gradient rows g * i_emb and g * u_emb (rounded to bf16 in the bf16 variant,
// then summed in f32) are summed in registers while the user (item) id stays the
// same and flushed with f32 atomicAdds into du (di) when it changes: the MF
// batch is grouped by user, so a user row takes about one atomic per run per
// column. The pre-update loss sum / B goes into losses[e] by one atomic per warp.
// An id outside [0, V) matches no row, as the Pallas one-hot mask matches none:
// its embedding is zero and it adds no gradient.
//
// mf_adam_kernel: one thread per master value of both tables applies torch Adam
// with L2 (dw = d + wd p; m, v; bias corrections 1 - exp(t log b) as the Pallas
// kernel computes them) and zeroes d for the next epoch.
//
// Bound: bytes. An epoch must read uid, iid and y (12 B a row: 2.76 MB at the MF
// preset's 229.7k rows) and read and write the two tables with their moments
// and gradients (2625 x 64 x 4 B = 0.67 MB each); the float work (about 400
// operations a row) takes less time at the float32 peak. The factor rows are read
// from L2 (the tables are 0.67 MB). The atomics onto the 943 user rows and 1682
// item rows are what this simple design pays for; a persistent single-launch
// kernel with per-block pre-aggregation in shared memory is later work.
//
// Each entry point returns cudaGetLastError() after its launch (or a cudaError_t
// for arguments it does not take); the Python launcher raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerWarp = 32;
constexpr int kMaxColsPerLane = 16;  // D <= 512: 4, 8 or 16 columns a lane (mf_epoch_kernel's kCols)
constexpr unsigned kFull = 0xffffffffu;

template <bool kBf16>
__device__ __forceinline__ float compute(float x) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int kCols>
__device__ __forceinline__ void flush(float* __restrict__ d, long long row, int D, int lane,
                                      const float (&acc)[kCols]) {
  if (row < 0) return;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int col = lane + 32 * k;
    if (col < D) atomicAdd(d + static_cast<size_t>(row) * D + col, acc[k]);
  }
}

template <bool kBf16, class Id, int kCols>
__global__ void __launch_bounds__(kThreads)
mf_epoch_kernel(const Id* __restrict__ uid, const Id* __restrict__ iid,
                const float* __restrict__ y, const float* __restrict__ pu,
                const float* __restrict__ pi, float* __restrict__ du, float* __restrict__ di,
                float* __restrict__ loss, long long B, int U, int I, int D) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long r0 = warp * kRowsPerWarp;
  if (r0 >= B) return;  // the whole warp leaves; no block barrier below
  const long long r1 = min(B, r0 + kRowsPerWarp);
  const float nb = static_cast<float>(B);

  float acc_u[kCols], acc_i[kCols];
  long long cur_u = -1, cur_i = -1;
  float loss_sum = 0.f;
  for (long long r = r0; r < r1; ++r) {
    const long long u = static_cast<long long>(uid[r]);
    const long long i = static_cast<long long>(iid[r]);
    const bool u_ok = u >= 0 && u < U;
    const bool i_ok = i >= 0 && i < I;
    float ue[kCols], ie[kCols];
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int col = lane + 32 * k;
      ue[k] = (col < D && u_ok) ? compute<kBf16>(pu[static_cast<size_t>(u) * D + col]) : 0.f;
      ie[k] = (col < D && i_ok) ? compute<kBf16>(pi[static_cast<size_t>(i) * D + col]) : 0.f;
      part = fmaf(ue[k], ie[k], part);
    }
    const float z = warp_sum(part);
    const float yr = y[r];
    loss_sum += fmaxf(z, 0.f) - z * yr + log1pf(expf(-fabsf(z)));
    const float g = (1.f / (1.f + expf(-z)) - yr) / nb;
    if (u_ok) {
      if (u != cur_u) {
        flush(du, cur_u, D, lane, acc_u);
        cur_u = u;
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc_u[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc_u[k] += compute<kBf16>(g * ie[k]);
    }
    if (i_ok) {
      if (i != cur_i) {
        flush(di, cur_i, D, lane, acc_i);
        cur_i = i;
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc_i[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc_i[k] += compute<kBf16>(g * ue[k]);
    }
  }
  flush(du, cur_u, D, lane, acc_u);
  flush(di, cur_i, D, lane, acc_i);
  if (lane == 0) atomicAdd(loss, loss_sum / nb);  // z and g are the same on every lane
}

struct Adam {
  float lr, wd, b1, one_minus_b1, b2, one_minus_b2, eps, log_b1, log_b2;
};

__device__ __forceinline__ void adam_step(float* p, float* m, float* v, float* d, size_t j,
                                          const Adam& a, float bc1, float bc2) {
  const float dw = d[j] + a.wd * p[j];
  const float mj = a.b1 * m[j] + a.one_minus_b1 * dw;
  const float vj = a.b2 * v[j] + a.one_minus_b2 * dw * dw;
  p[j] = p[j] - a.lr * (mj / bc1) / (sqrtf(vj / bc2) + a.eps);
  m[j] = mj;
  v[j] = vj;
  d[j] = 0.f;
}

__global__ void __launch_bounds__(kThreads)
mf_adam_kernel(float* __restrict__ pu, float* __restrict__ mu, float* __restrict__ vu,
               float* __restrict__ du, long long nu, float* __restrict__ pi,
               float* __restrict__ mi, float* __restrict__ vi, float* __restrict__ di,
               long long ni, Adam a, int step) {
  const float t = static_cast<float>(step);
  const float bc1 = 1.f - expf(t * a.log_b1);
  const float bc2 = 1.f - expf(t * a.log_b2);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j < nu + ni;
       j += stride) {
    if (j < nu) {
      adam_step(pu, mu, vu, du, static_cast<size_t>(j), a, bc1, bc2);
    } else {
      adam_step(pi, mi, vi, di, static_cast<size_t>(j - nu), a, bc1, bc2);
    }
  }
}

template <bool kBf16, class Id>
cudaError_t launch_epoch(const void* uid, const void* iid, const float* y, const float* pu,
                         const float* pi, float* du, float* di, float* loss, long long B, int U,
                         int I, int D, cudaStream_t stream) {
  const long long warps = (B + kRowsPerWarp - 1) / kRowsPerWarp;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  // the fewest columns a lane that cover D: D <= 128 keeps the 4-column kernel
  auto kernel = D <= 128 ? mf_epoch_kernel<kBf16, Id, 4>
                : D <= 256 ? mf_epoch_kernel<kBf16, Id, 8>
                           : mf_epoch_kernel<kBf16, Id, 16>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const Id*>(uid), static_cast<const Id*>(iid), y, pu, pi, du, di, loss, B, U, I,
      D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int mf_epoch_max_dim() { return 32 * kMaxColsPerLane; }

const char* mf_epoch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One epoch's forward and backward. uid, iid [B] int32 (id_bytes 4) or int64
// (8); y [B] f32; pu [U, D], pi [I, D] f32 masters; du [U, D], di [I, D] f32
// zeroed gradient sums; loss points at this epoch's f32 slot, zeroed.
int mf_epoch_forward_backward(const void* uid, const void* iid, const void* y, const void* pu,
                              const void* pi, void* du, void* di, void* loss, long long B, int U,
                              int I, int D, int bf16, int id_bytes, void* stream) {
  if (B < 1 || U < 1 || I < 1 || D < 1 || D > 32 * kMaxColsPerLane) return cudaErrorInvalidValue;
  if ((B + kRowsPerWarp - 1) / kRowsPerWarp * 32 / kThreads + 1 > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* yf = static_cast<const float*>(y);
  const auto* puf = static_cast<const float*>(pu);
  const auto* pif = static_cast<const float*>(pi);
  auto* duf = static_cast<float*>(du);
  auto* dif = static_cast<float*>(di);
  auto* lf = static_cast<float*>(loss);
  if (id_bytes == 4) {
    return bf16 ? launch_epoch<true, int>(uid, iid, yf, puf, pif, duf, dif, lf, B, U, I, D, s)
                : launch_epoch<false, int>(uid, iid, yf, puf, pif, duf, dif, lf, B, U, I, D, s);
  }
  if (id_bytes == 8) {
    return bf16
               ? launch_epoch<true, long long>(uid, iid, yf, puf, pif, duf, dif, lf, B, U, I, D, s)
               : launch_epoch<false, long long>(uid, iid, yf, puf, pif, duf, dif, lf, B, U, I, D,
                                                s);
  }
  return cudaErrorInvalidValue;
}

// Adam step `step` (1-based) over both tables; zeroes du and di. Every array
// is f32: the user table's nu = U * D values, the item table's ni = I * D.
int mf_epoch_adam(void* pu, void* mu, void* vu, void* du, long long nu, void* pi, void* mi,
                  void* vi, void* di, long long ni, float lr, float wd, float b1,
                  float one_minus_b1, float b2, float one_minus_b2, float eps, float log_b1,
                  float log_b2, int step, void* stream) {
  if (nu < 1 || ni < 1 || step < 1) return cudaErrorInvalidValue;
  const Adam a{lr, wd, b1, one_minus_b1, b2, one_minus_b2, eps, log_b1, log_b2};
  const long long blocks = min((nu + ni + kThreads - 1) / kThreads, 132LL * 16);
  mf_adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(pu), static_cast<float*>(mu), static_cast<float*>(vu),
      static_cast<float*>(du), nu, static_cast<float*>(pi), static_cast<float*>(mi),
      static_cast<float*>(vi), static_cast<float*>(di), ni, a, step);
  return cudaGetLastError();
}

}  // extern "C"
