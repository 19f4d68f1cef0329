// Full-batch LR training epochs for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces the two Pallas TPU kernels of
//   deeplearningrecommendationsystem_tpu/ops/pallas/lr_epoch.py:
//   * lr_fullbatch_train         (_epoch_kernel)   -> lr_wide_epoch_kernel + lr_adam_kernel
//   * lr_fullbatch_train_compact (_compact_kernel) -> lr_compact_epoch_kernel + lr_adam_kernel
// Their plain PyTorch versions are lr_fullbatch_train_plain and
// lr_fullbatch_train_compact_plain in deeplearningrecommendationsystem_tpu_torch/ops/lr_epoch.py.
//
// Each epoch: z = the row's score, the pre-update loss (stable BCE-with-logits,
// mean over the B rows), g = (sigmoid(z) - y) / B, dw = X^T g, then one torch-Adam
// step (no weight decay; bias corrections 1 - exp(t log b) in f32, as the Pallas
// kernels compute them). The Pallas kernels carried dw and the loss in an output
// block across a grid the TPU runs in order and applied Adam at the last block.
// CUDA blocks run in no order, so each epoch is two launches on one stream: the
// epoch kernel writes per-block partial sums, and lr_adam_kernel reduces them in
// a fixed order (a warp per dense weight) and takes the Adam step. The host loops over
// the epochs without synchronising.
//
// lr_wide_epoch_kernel (mode "wide", X = [user one-hot, item one-hot, dense, 1],
// [B, F] f32, F = 2669 at ml-100k). Bound: bytes. X is read once an epoch: 69,040
// rows x 2669 x 4 B = 737 MB at the LR preset's train batch, 0.22 ms at 3.35 TB/s;
// the 2 F operations a row take less. So a block stages a tile of R <= 16 whole
// rows in shared memory (16 x 2669 x 4 B = 171 KB; the tile is one contiguous
// span of X, copied as float4s), each warp takes a row's z by a warp reduction
// against the weights (also in shared memory), and each thread then adds g x its
// columns of the staged tile into the block's partial dw, kept in shared memory:
// X leaves device memory once, and the block's dw partial goes out once at its
// end. One block per SM walks over the tiles.
//
// lr_compact_epoch_kernel (mode "compact"): the one-hot terms of X are rebuilt
// from the ids, w[uid] and w[u_pad + iid], and only uid, iid, y and the dense block
// [B, d_pad] are read: 69,040 x (4 + 4 + 4 + 44 x 4) B = 13 MB an epoch, about 4 us
// at 3.35 TB/s, so launches and latency, not bytes, set its time. A warp takes one
// row at a time (lanes over the dense columns, z by a warp reduction). The id
// gradients go into per-block bins in shared memory (u_pad + i_pad f32: 10.5 KB at
// ml-100k) by shared atomics, flushed with one global atomicAdd per nonzero bin; the
// dense gradient stays in registers and leaves as per-block partials, reduced like
// the wide kernel's. An id outside [0, u_pad) (or [0, i_pad)) matches no lane, as
// the Pallas kernel's iota == id mask matches none.
//
// Each entry point returns cudaGetLastError() after its launch (or a cudaError_t
// for arguments it does not take); the Python launcher raises when it is not 0.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWideThreads = 512;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kMaxTileRows = 16;
constexpr int kCompactThreads = 256;
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kMaxDenseColsPerLane = 4;  // d_pad <= 128
constexpr int kAdamThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float bce(float z, float y) {
  return fmaxf(z, 0.f) - z * y + log1pf(expf(-fabsf(z)));
}

__device__ __forceinline__ float sigmoid(float z) { return 1.f / (1.f + expf(-z)); }

size_t wide_smem_bytes(int F, int R) {
  return sizeof(float) * (static_cast<size_t>(R) * F + 2 * static_cast<size_t>(F) + kMaxTileRows +
                          kWideWarps);
}

// Shared memory: xs [R * F] | ws [F] | dws [F] | gs [kMaxTileRows] | red [kWideWarps].
__global__ void __launch_bounds__(kWideThreads)
lr_wide_epoch_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ w, float* __restrict__ dw_part,
                     float* __restrict__ loss_part, long long B, int F, int R) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ws = xs + static_cast<size_t>(R) * F;
  float* dws = ws + F;
  float* gs = dws + F;
  float* red = gs + kMaxTileRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < F; c += kWideThreads) {
    ws[c] = w[c];
    dws[c] = 0.f;
  }
  const float nb = static_cast<float>(B);
  // float4 copies need every tile to start on 16 bytes: x aligned and R F % 4 == 0
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && (static_cast<long long>(R) * F) % 4 == 0;
  const long long tiles = (B + R - 1) / R;
  float loss = 0.f;  // this warp's rows (lane 0)
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * R;
    const int rows = static_cast<int>(min(static_cast<long long>(R), B - r0));
    const size_t n = static_cast<size_t>(rows) * F;
    const float* src = x + static_cast<size_t>(r0) * F;
    __syncthreads();  // the previous tile's readers are done with xs and gs
    size_t done = 0;
    if (vec) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      float4* xs4 = reinterpret_cast<float4*>(xs);
      const size_t n4 = n / 4;
#pragma unroll 4
      for (size_t i = tid; i < n4; i += kWideThreads) xs4[i] = __ldg(src4 + i);
      done = n4 * 4;
    }
    for (size_t i = done + tid; i < n; i += kWideThreads) xs[i] = __ldg(src + i);
    __syncthreads();
    // rows past B are never loaded and never read: no mask multiplies garbage
    for (int r = warp; r < rows; r += kWideWarps) {
      const float* xr = xs + static_cast<size_t>(r) * F;
      float part = 0.f;
      for (int c = lane; c < F; c += 32) part = fmaf(xr[c], ws[c], part);
      const float z = warp_sum(part);
      if (lane == 0) {
        const float yr = y[r0 + r];
        loss += bce(z, yr);
        gs[r] = (sigmoid(z) - yr) / nb;
      }
    }
    __syncthreads();
    for (int c = tid; c < F; c += kWideThreads) {
      float acc = dws[c];
      for (int r = 0; r < rows; ++r) acc = fmaf(gs[r], xs[static_cast<size_t>(r) * F + c], acc);
      dws[c] = acc;
    }
  }
  if (lane == 0) red[warp] = loss;
  __syncthreads();
  float* out = dw_part + static_cast<size_t>(blockIdx.x) * F;
  for (int c = tid; c < F; c += kWideThreads) out[c] = dws[c];
  if (tid == 0) {
    float s = 0.f;
    for (int q = 0; q < kWideWarps; ++q) s += red[q];
    loss_part[blockIdx.x] = s;
  }
}

// Shared memory: bins [u_pad + i_pad] | dwp [kCompactWarps][d_pad] | lossw [kCompactWarps].
template <class Id>
__global__ void __launch_bounds__(kCompactThreads)
lr_compact_epoch_kernel(const Id* __restrict__ uid, const Id* __restrict__ iid,
                        const float* __restrict__ dense, const float* __restrict__ y,
                        const float* __restrict__ w, float* __restrict__ dg,
                        float* __restrict__ dense_part, float* __restrict__ loss_part, long long B,
                        int u_pad, int i_pad, int d_pad) {
  extern __shared__ __align__(16) float smem[];
  const int nbins = u_pad + i_pad;
  float* bins = smem;
  float* dwp = bins + nbins;
  float* lossw = dwp + kCompactWarps * d_pad;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < nbins; j += kCompactThreads) bins[j] = 0.f;
  const float* wu = w;
  const float* wi = w + u_pad;
  const float* wd = w + nbins;
  float wdr[kMaxDenseColsPerLane], acc[kMaxDenseColsPerLane];
#pragma unroll
  for (int k = 0; k < kMaxDenseColsPerLane; ++k) {
    const int col = lane + 32 * k;
    wdr[k] = col < d_pad ? wd[col] : 0.f;
    acc[k] = 0.f;
  }
  __syncthreads();
  const float nb = static_cast<float>(B);
  const long long stride = static_cast<long long>(gridDim.x) * kCompactWarps;
  float loss = 0.f;
  for (long long r = static_cast<long long>(blockIdx.x) * kCompactWarps + warp; r < B; r += stride) {
    const long long u = static_cast<long long>(uid[r]);
    const long long i = static_cast<long long>(iid[r]);
    const bool u_ok = u >= 0 && u < u_pad;
    const bool i_ok = i >= 0 && i < i_pad;
    float d[kMaxDenseColsPerLane];
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxDenseColsPerLane; ++k) {
      const int col = lane + 32 * k;
      d[k] = col < d_pad ? dense[static_cast<size_t>(r) * d_pad + col] : 0.f;
      part = fmaf(d[k], wdr[k], part);
    }
    const float z = (u_ok ? wu[u] : 0.f) + (i_ok ? wi[i] : 0.f) + warp_sum(part);
    const float yr = y[r];
    const float g = (sigmoid(z) - yr) / nb;
#pragma unroll
    for (int k = 0; k < kMaxDenseColsPerLane; ++k) acc[k] = fmaf(g, d[k], acc[k]);
    if (lane == 0) {
      loss += bce(z, yr);
      if (u_ok) atomicAdd(bins + u, g);
      if (i_ok) atomicAdd(bins + u_pad + i, g);
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxDenseColsPerLane; ++k) {
    const int col = lane + 32 * k;
    if (col < d_pad) dwp[warp * d_pad + col] = acc[k];
  }
  if (lane == 0) lossw[warp] = loss;
  __syncthreads();
  for (int c = tid; c < d_pad; c += kCompactThreads) {
    float s = 0.f;
    for (int q = 0; q < kCompactWarps; ++q) s += dwp[q * d_pad + c];
    dense_part[static_cast<size_t>(blockIdx.x) * d_pad + c] = s;
  }
  if (tid == 0) {
    float s = 0.f;
    for (int q = 0; q < kCompactWarps; ++q) s += lossw[q];
    loss_part[blockIdx.x] = s;
  }
  for (int j = tid; j < nbins; j += kCompactThreads) {
    const float b = bins[j];
    if (b != 0.f) atomicAdd(dg + j, b);
  }
}

struct Adam {
  float lr, b1, one_minus_b1, b2, one_minus_b2, eps, log_b1, log_b2;
};

// sum over b < nparts of part[b * stride + col], on every lane of the warp: lane
// l adds b = l, l + 32, ... in order, then a butterfly over the lanes. The order
// is fixed, so the sum is the same every run.
__device__ __forceinline__ float sum_parts(const float* __restrict__ part, int nparts, int stride,
                                           int col, int lane) {
  float s = 0.f;
  for (int b = lane; b < nparts; b += 32) s += part[static_cast<size_t>(b) * stride + col];
  return warp_sum(s);
}

// Both modes' second launch. Values j < n_sparse take their gradient from dg
// (and zero it for the next epoch), a thread each; dense value n_sparse + c sums
// the nparts partial rows part[b][c], a warp each (sum_parts); then one Adam step
// on every value. Warp 0 of block 0 writes the epoch's loss, the partial losses
// summed the same way, over B.
__global__ void __launch_bounds__(kAdamThreads)
lr_adam_kernel(float* __restrict__ w, float* __restrict__ m, float* __restrict__ v,
               float* __restrict__ dg, int n_sparse, const float* __restrict__ part, int n_dense,
               const float* __restrict__ loss_part, int nparts, float* __restrict__ loss_out,
               long long B, Adam a, int step) {
  const float t = static_cast<float>(step);
  const float bc1 = 1.f - expf(t * a.log_b1);
  const float bc2 = 1.f - expf(t * a.log_b2);
  const int lane = threadIdx.x & 31;
  // the dense section starts on a whole warp, and every bound and stride below is
  // a multiple of 32: a warp stays together in it
  const int sparse_threads = (n_sparse + 31) & ~31;
  const int n = sparse_threads + 32 * n_dense;
  for (int i = blockIdx.x * kAdamThreads + threadIdx.x; i < n; i += gridDim.x * kAdamThreads) {
    int j;
    float dw;
    if (i < sparse_threads) {
      if (i >= n_sparse) continue;
      j = i;
      dw = dg[j];
      dg[j] = 0.f;
    } else {
      const int c = (i - sparse_threads) >> 5;
      dw = sum_parts(part, nparts, n_dense, c, lane);
      if (lane != 0) continue;
      j = n_sparse + c;
    }
    const float mj = a.b1 * m[j] + a.one_minus_b1 * dw;
    const float vj = a.b2 * v[j] + a.one_minus_b2 * dw * dw;
    w[j] = w[j] - a.lr * (mj / bc1) / (sqrtf(vj / bc2) + a.eps);
    m[j] = mj;
    v[j] = vj;
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const float s = sum_parts(loss_part, nparts, 1, 0, lane);
    if (lane == 0) *loss_out = s / static_cast<float>(B);
  }
}

template <class Id>
cudaError_t launch_compact(const void* uid, const void* iid, const float* dense, const float* y,
                           const float* w, float* dg, float* dense_part, float* loss_part,
                           long long B, int u_pad, int i_pad, int d_pad, int blocks, size_t smem,
                           cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lr_compact_epoch_kernel<Id>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  lr_compact_epoch_kernel<Id><<<blocks, kCompactThreads, smem, s>>>(
      static_cast<const Id*>(uid), static_cast<const Id*>(iid), dense, y, w, dg, dense_part,
      loss_part, B, u_pad, i_pad, d_pad);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* lr_epoch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int lr_epoch_max_tile_rows() { return kMaxTileRows; }

int lr_epoch_max_dense() { return 32 * kMaxDenseColsPerLane; }

size_t lr_wide_smem_bytes(int F, int R) { return wide_smem_bytes(F, R); }

size_t lr_compact_smem_bytes(int u_pad, int i_pad, int d_pad) {
  return sizeof(float) * (static_cast<size_t>(u_pad) + i_pad + kCompactWarps * (d_pad + 1));
}

// One wide epoch's forward and backward. x [B, F], y [B], w [F] f32; dw_part
// [blocks, F] and loss_part [blocks] f32 receive the per-block sums; R rows a tile.
int lr_wide_epoch(const void* x, const void* y, const void* w, void* dw_part, void* loss_part,
                  long long B, int F, int R, int blocks, void* stream) {
  if (B < 1 || F < 1 || R < 1 || R > kMaxTileRows || blocks < 1) return cudaErrorInvalidValue;
  const size_t smem = wide_smem_bytes(F, R);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lr_wide_epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  lr_wide_epoch_kernel<<<blocks, kWideThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const float*>(w),
      static_cast<float*>(dw_part), static_cast<float*>(loss_part), B, F, R);
  return cudaGetLastError();
}

// One compact epoch's forward and backward. uid, iid [B] int32 (id_bytes 4) or
// int64 (8); dense [B, d_pad], y [B], w [u_pad + i_pad + d_pad] f32; dg [u_pad +
// i_pad] f32 zeroed id-gradient sums; dense_part [blocks, d_pad], loss_part [blocks].
int lr_compact_epoch(const void* uid, const void* iid, const void* dense, const void* y,
                     const void* w, void* dg, void* dense_part, void* loss_part, long long B,
                     int u_pad, int i_pad, int d_pad, int blocks, int id_bytes, void* stream) {
  if (B < 1 || u_pad < 1 || i_pad < 1 || d_pad < 1 || d_pad > 32 * kMaxDenseColsPerLane ||
      blocks < 1) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = lr_compact_smem_bytes(u_pad, i_pad, d_pad);
  const auto* df = static_cast<const float*>(dense);
  const auto* yf = static_cast<const float*>(y);
  const auto* wf = static_cast<const float*>(w);
  auto* dgf = static_cast<float*>(dg);
  auto* dpf = static_cast<float*>(dense_part);
  auto* lpf = static_cast<float*>(loss_part);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id_bytes == 4) {
    return launch_compact<int>(uid, iid, df, yf, wf, dgf, dpf, lpf, B, u_pad, i_pad, d_pad, blocks,
                               smem, s);
  }
  if (id_bytes == 8) {
    return launch_compact<long long>(uid, iid, df, yf, wf, dgf, dpf, lpf, B, u_pad, i_pad, d_pad,
                                     blocks, smem, s);
  }
  return cudaErrorInvalidValue;
}

// Adam step `step` (1-based) over w, m, v [n_sparse + n_dense] f32, the gradient
// from dg [n_sparse] (zeroed here) and from part [nparts, n_dense] (summed in a
// fixed order); loss_out = sum(loss_part [nparts]) / B.
int lr_adam(void* w, void* m, void* v, void* dg, int n_sparse, const void* part, int n_dense,
            const void* loss_part, int nparts, void* loss_out, long long B, float lr, float b1,
            float one_minus_b1, float b2, float one_minus_b2, float eps, float log_b1,
            float log_b2, int step, void* stream) {
  if (n_sparse < 0 || n_dense < 0 || n_sparse + n_dense < 1 || nparts < 1 || B < 1 || step < 1) {
    return cudaErrorInvalidValue;
  }
  const Adam a{lr, b1, one_minus_b1, b2, one_minus_b2, eps, log_b1, log_b2};
  const int n = ((n_sparse + 31) & ~31) + 32 * n_dense;  // threads of lr_adam_kernel
  const int blocks = min((n + kAdamThreads - 1) / kAdamThreads, 132 * 8);
  lr_adam_kernel<<<blocks, kAdamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(w), static_cast<float*>(m), static_cast<float*>(v),
      static_cast<float*>(dg), n_sparse, static_cast<const float*>(part), n_dense,
      static_cast<const float*>(loss_part), nparts, static_cast<float*>(loss_out), B, a, step);
  return cudaGetLastError();
}

}  // extern "C"
