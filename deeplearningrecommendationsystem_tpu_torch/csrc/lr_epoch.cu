// Full-batch LR training for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces the two Pallas TPU kernels of
//   deeplearningrecommendationsystem_tpu/ops/pallas/lr_epoch.py:
//   * lr_fullbatch_train         (_epoch_kernel)   -> lr_wide_epoch_kernel + lr_adam_kernel
//   * lr_fullbatch_train_compact (_compact_kernel) -> lr_compact_train_kernel
// Their plain PyTorch versions are lr_fullbatch_train_plain and
// lr_fullbatch_train_compact_plain in deeplearningrecommendationsystem_tpu_torch/ops/lr_epoch.py.
//
// Each epoch: z = the row's score, the pre-update loss (stable BCE-with-logits,
// mean over the B rows), g = (sigmoid(z) - y) / B, dw = X^T g, then one torch-Adam
// step (no weight decay; bias corrections 1 - exp(t log b) in f32, as the Pallas
// kernels compute them). The Pallas kernels carried dw and the loss in an output
// block across a grid the TPU runs in order and applied Adam at the last block.
// Every sum below has a fixed order, so two calls give the same bits.
//
// lr_wide_epoch_kernel (mode "wide", X = [user one-hot, item one-hot, dense, 1],
// [B, F] f32, F = 2669 at ml-100k), two launches an epoch on one stream: the
// epoch kernel writes per-block partial sums, and lr_adam_kernel reduces them in
// a fixed order (a warp per dense weight) and takes the Adam step; the host loops
// over the epochs without synchronising. Bound: bytes. X is read once an epoch:
// 69,040 rows x 2669 x 4 B = 737 MB at the LR preset's train batch, 0.22 ms at
// 3.35 TB/s; the 2 F operations a row take less. So a block stages a tile of R <=
// 16 whole rows in shared memory (16 x 2669 x 4 B = 171 KB; the tile is one
// contiguous span of X, copied as float4s), each warp takes a row's z by a warp
// reduction against the weights (also in shared memory), and each thread then adds
// g x its columns of the staged tile into the block's partial dw, kept in shared
// memory: X leaves device memory once, and the block's dw partial goes out once at
// its end. One block per SM walks over the tiles.
//
// lr_compact_train_kernel (mode "compact"), the whole run in one cooperative
// launch (cudaLaunchCooperativeKernel, every block resident), as the Pallas call is
// one grid: the one-hot terms of X are rebuilt from the ids, w[uid] and w[u_pad +
// iid], and only uid, iid, y and the dense block [B, d_pad] are read: 69,040 x (4 +
// 4 + 4 + 44 x 4) B = 13 MB an epoch, which stays in the 50 MB L2 across epochs, so
// latency and barriers, not bytes, set its time. A prologue copies w0, zeroes
// the moments and writes each row's place in the user and the item order; then
// each epoch is two phases, each ended by a grid barrier
// (cooperative_groups grid.sync(), cheaper on this card than a launch):
//   the gradient phase: warp w takes the blocks of 32 rows w, w + warps, ...:
//   it copies the block's dense rows
//   (one contiguous span) into its shared memory with cp.async while lane l
//   loads row l's ids, label and places in the two orders; then kRowsPerStep
//   rows at a time, kRowLanes lanes a row (its dense columns j, j + 8, ...; z by
//   a reduction over the row's lanes), it computes each row's g, which lane l
//   writes to row l's places in both orders, and keeps the dense gradient in
//   registers, which leaves as the block's partial (its warps summed in order),
//   with the block's loss;
//   the Adam phase: a warp a weight. An id weight sums g over the rows of its id
//   in segment order, a contiguous span of that order's g (ops/segments.py::
//   id_segments builds each id's rows in row order once a call: the ids do not
//   change across epochs), a dense weight the block partials in block order;
//   lane 0 takes the Adam step. One more warp sums the loss. No atomics.
// An id outside [0, u_pad) (or [0, i_pad)) lies in no segment and matches no lane,
// as the Pallas kernel's iota == id mask matches none; ids in [U, u_pad) train
// their padded lane.
//
// Each entry point returns its launch's cudaError_t (or one for arguments it does
// not take); the Python launcher raises when it is not 0. A cooperative grid that
// cannot be resident (cudaErrorCooperativeLaunchTooLarge) is such an error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWideThreads = 512;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kMaxTileRows = 16;
constexpr int kCompactThreads = 256;
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kMaxDense = 128;                         // d_pad <= 128
constexpr int kRowLanes = 8;                           // the compact kernel's lanes a row
constexpr int kRowsPerStep = 32 / kRowLanes;           // rows a warp takes at a time
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

// lr_compact_train_kernel: a whole compact run in one cooperative launch. Shared
// memory: dwp [kCompactWarps][kMaxDense] | lossw [kCompactWarps].
struct CompactParams {
  const void* ids[2];           // uid, iid: int32 (id_bytes 4) or int64 (8)
  const long long* order[2];    // id_segments(uid, u_pad), id_segments(iid, i_pad)
  const long long* off[2];
  const float* dense;           // [B, d_pad]
  const float* y;               // [B]
  const float* w0;              // [u_pad + i_pad + d_pad]
  float* w;
  float* m;
  float* v;
  int* rank[2];                 // [B] each row's position in the user (item) order
  float* gs[2];                 // [B] this epoch's g = (sigmoid(z) - y) / B in that order
  float* dense_part;            // [gridDim.x, d_pad]
  float* loss_part;             // [gridDim.x]
  float* losses;                // [E]
  long long B;
  int u_pad, i_pad, d_pad, E, id_bytes;
  Adam a;
};

// sum over i < n of x[i * stride] on every lane of the warp, for values written
// inside the launch (loads from L2, .cg): lane l adds i = l, l + 32, ... in
// order, eight loads in flight, then a butterfly over the lanes.
__device__ __forceinline__ float sum_strided_cg(const float* x, long long n, int stride, int lane) {
  float s = 0.f;
  for (long long i = lane; i < n; i += 256) {
    float v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = i + 32 * t < n ? __ldcg(x + (i + 32 * t) * stride) : 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (i + 32 * t < n) s += v[t];
    }
  }
  return warp_sum(s);
}

// Id r of an int32 (id_bytes 4) or int64 (8) id array.
__device__ __forceinline__ long long load_id(const void* ids, int id_bytes, long long r) {
  return id_bytes == 8 ? __ldg(static_cast<const long long*>(ids) + r)
                       : static_cast<long long>(__ldg(static_cast<const int*>(ids) + r));
}

// 16 bytes into shared memory, the first src_bytes of them from src (L2 only,
// .cg), the rest zeros.
__device__ __forceinline__ void cp_async16_part(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

template <int kDense>
__global__ void __launch_bounds__(kCompactThreads) lr_compact_train_kernel(CompactParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float dwp[kCompactWarps][kMaxDense];
  __shared__ float lossw[kCompactWarps];
  extern __shared__ __align__(16) float dyn[];  // each warp's block of 32 dense rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / kRowLanes, j = lane % kRowLanes;  // a row's group of lanes, lane in it
  const long long tid = static_cast<long long>(blockIdx.x) * kCompactThreads + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kCompactThreads;
  const long long gwarp = tid >> 5, nwarps = nthreads >> 5;
  const long long B = P.B;
  const int u_pad = P.u_pad, i_pad = P.i_pad, d_pad = P.d_pad;
  const int n_sparse = u_pad + i_pad, n = n_sparse + d_pad;
  const float nb = static_cast<float>(B);
  float* xs = dyn + warp * 32 * d_pad;
  // the Adam phase's warp for weight t is t mod nwarps, lane 0: the prologue
  // writes each weight from that lane, and no other thread writes it
  for (long long t = gwarp; t < n; t += nwarps) {
    if (lane == 0) {
      P.w[t] = __ldg(P.w0 + t);
      P.m[t] = 0.f;
      P.v[t] = 0.f;
    }
  }
#pragma unroll 4
  for (long long t = tid; t < 2 * B; t += nthreads) {
    const int q = t >= B;
    const long long p = t - q * B;
    P.rank[q][__ldg(P.order[q] + p)] = static_cast<int>(p);
  }
  grid.sync();

  const Adam& a = P.a;
  for (int e = 0; e < P.E; ++e) {
    float wdr[kDense], acc[kDense];
#pragma unroll
    for (int k = 0; k < kDense; ++k) {
      const int col = j + kRowLanes * k;
      wdr[k] = col < d_pad ? __ldcg(P.w + n_sparse + col) : 0.f;
      acc[k] = 0.f;
    }
    float loss = 0.f;  // lane l: the loss of row 32 rb + l of each block of rows it takes
    // warp gwarp takes the blocks of 32 rows rb = gwarp, gwarp + nwarps, ...: lane l
    // loads row 32 rb + l's ids, label and places, all lanes the block's dense
    // rows (kRowLanes lanes a row, kRowsPerStep rows a step), all before the first
    // use
    for (long long rb = gwarp; rb * 32 < B; rb += nwarps) {
      // the block's dense rows: one contiguous span of 32 d_pad floats (a multiple
      // of 16 bytes from a 16-byte boundary), copied into the warp's xs in 16-byte
      // pieces, zeros past B
      {
        __syncwarp();  // the previous block's readers are done with xs
        const long long bytes = (min(B, rb * 32 + 32) - rb * 32) * d_pad * 4;
        const char* src = reinterpret_cast<const char*>(P.dense + rb * 32 * d_pad);
        for (int u = lane; u < 8 * d_pad; u += 32) {
          const long long left = bytes - 16LL * u;
          cp_async16_part(xs + 4 * u, src + 16LL * u,
                          left >= 16 ? 16 : (left > 0 ? static_cast<int>(left) : 0));
        }
        tf32mma::cp_async_commit();
      }
      const long long r_lane = rb * 32 + lane;
      const bool ok_lane = r_lane < B;
      long long u = -1, i = -1;
      float y_lane = 0.f;
      int ru = 0, ri = 0;
      if (ok_lane) {
        u = load_id(P.ids[0], P.id_bytes, r_lane);
        i = load_id(P.ids[1], P.id_bytes, r_lane);
        y_lane = __ldg(P.y + r_lane);
        ru = __ldcg(P.rank[0] + r_lane);
        ri = __ldcg(P.rank[1] + r_lane);
      }
      const float wui = ((u >= 0 && u < u_pad) ? __ldcg(P.w + u) : 0.f) +
                        ((i >= 0 && i < i_pad) ? __ldcg(P.w + u_pad + i) : 0.f);
      float z_lane = 0.f, g_lane = 0.f;
      tf32mma::cp_async_wait_all();
      __syncwarp();  // every lane's copies have landed
#pragma unroll 4
      for (int step = 0; step < 32 / kRowsPerStep; ++step) {
        const int rl = kRowsPerStep * step + grp;  // the row of this lane's group
        float d[kDense];
        float part = 0.f;
#pragma unroll
        for (int k = 0; k < kDense; ++k) {
          const int col = j + kRowLanes * k;
          d[k] = col < d_pad ? xs[rl * d_pad + col] : 0.f;  // zeros past B
          part = fmaf(d[k], wdr[k], part);
        }
#pragma unroll
        for (int off = kRowLanes / 2; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
        const float z = __shfl_sync(kFull, wui, rl) + part;
        const float yr = __shfl_sync(kFull, y_lane, rl);
        const float g = rb * 32 + rl < B ? (sigmoid(z) - yr) / nb : 0.f;
#pragma unroll
        for (int k = 0; k < kDense; ++k) acc[k] = fmaf(g, d[k], acc[k]);
        // lane l's row is computed at step l / kRowsPerStep by group l % kRowsPerStep
        const int from = (lane % kRowsPerStep) * kRowLanes;
        const float zl = __shfl_sync(kFull, z, from), gl = __shfl_sync(kFull, g, from);
        if (lane / kRowsPerStep == step) {
          z_lane = zl;
          g_lane = gl;
        }
      }
      if (ok_lane) {
        loss += bce(z_lane, y_lane);
        P.gs[0][ru] = g_lane;
        P.gs[1][ri] = g_lane;
      }
    }
    // the warp's dense partial: its groups of lanes summed in a fixed order
#pragma unroll
    for (int off = kRowLanes; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < kDense; ++k) acc[k] += __shfl_xor_sync(kFull, acc[k], off);
    }
    loss = warp_sum(loss);
    if (grp == 0) {
#pragma unroll
      for (int k = 0; k < kDense; ++k) {
        const int col = j + kRowLanes * k;
        if (col < d_pad) dwp[warp][col] = acc[k];
      }
    }
    if (lane == 0) lossw[warp] = loss;
    __syncthreads();
    for (int c = threadIdx.x; c < d_pad; c += kCompactThreads) {
      float s = 0.f;
      for (int q = 0; q < kCompactWarps; ++q) s += dwp[q][c];
      P.dense_part[static_cast<size_t>(blockIdx.x) * d_pad + c] = s;
    }
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int q = 0; q < kCompactWarps; ++q) s += lossw[q];
      P.loss_part[blockIdx.x] = s;
    }
    grid.sync();

    // a warp a weight: an id weight sums g over its segment in segment order, a
    // dense weight the block partials in block order; one more warp the loss
    const float t = static_cast<float>(e + 1);
    const float bc1 = 1.f - expf(t * a.log_b1);
    const float bc2 = 1.f - expf(t * a.log_b2);
    for (long long wt = gwarp; wt <= n; wt += nwarps) {
      float dw;
      if (wt < n_sparse) {
        const int q = wt >= u_pad;
        const long long sgm = wt - q * u_pad;
        const long long lo = __ldg(P.off[q] + sgm), hi = __ldg(P.off[q] + sgm + 1);
        dw = sum_strided_cg(P.gs[q] + lo, hi - lo, 1, lane);
      } else if (wt < n) {
        dw = sum_strided_cg(P.dense_part + (wt - n_sparse), gridDim.x, d_pad, lane);
      } else {
        const float s = sum_strided_cg(P.loss_part, gridDim.x, 1, lane);
        if (lane == 0) P.losses[e] = s / nb;
        continue;
      }
      if (lane == 0) {
        const float mj = a.b1 * P.m[wt] + a.one_minus_b1 * dw;
        const float vj = a.b2 * P.v[wt] + a.one_minus_b2 * dw * dw;
        P.w[wt] = P.w[wt] - a.lr * (mj / bc1) / (sqrtf(vj / bc2) + a.eps);
        P.m[wt] = mj;
        P.v[wt] = vj;
      }
    }
    if (e + 1 < P.E) grid.sync();
  }
}

// The compact kernel for d_pad: its dense columns a lane, ceil(d_pad / 8) rounded
// up to 2, 4, 6, 8 or 16.
const void* compact_kernel_for(int d_pad) {
  return d_pad <= 16   ? reinterpret_cast<const void*>(lr_compact_train_kernel<2>)
         : d_pad <= 32 ? reinterpret_cast<const void*>(lr_compact_train_kernel<4>)
         : d_pad <= 48 ? reinterpret_cast<const void*>(lr_compact_train_kernel<6>)
         : d_pad <= 64 ? reinterpret_cast<const void*>(lr_compact_train_kernel<8>)
                       : reinterpret_cast<const void*>(lr_compact_train_kernel<16>);
}

size_t align256(size_t bytes) { return (bytes + 255) & ~static_cast<size_t>(255); }

// Dynamic shared memory of the compact kernel: each warp's 32 dense rows. Allows
// it (with the static part, past 48 KB).
size_t compact_smem(const void* kernel, int d_pad, cudaError_t* err) {
  const size_t bytes = sizeof(float) * static_cast<size_t>(kCompactWarps) * 32 * d_pad;
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
  return bytes;
}

}  // namespace

extern "C" {

const char* lr_epoch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int lr_epoch_max_tile_rows() { return kMaxTileRows; }

int lr_epoch_max_dense() { return kMaxDense; }

size_t lr_wide_smem_bytes(int F, int R) { return wide_smem_bytes(F, R); }

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

// Blocks of lr_compact_train_kernel that the current device keeps resident at
// once for this d_pad: the SM count times the blocks an SM holds. 0 on an error.
int lr_compact_grid(int d_pad) {
  int dev = 0, sms = 0, fit = 0;
  cudaError_t err = cudaSuccess;
  const void* kernel = d_pad >= 1 && d_pad <= kMaxDense ? compact_kernel_for(d_pad) : nullptr;
  const size_t smem = kernel != nullptr ? compact_smem(kernel, d_pad, &err) : 0;
  if (kernel == nullptr || err != cudaSuccess || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kCompactThreads, smem) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return sms * fit;
}

// Bytes of the workspace lr_compact_train needs: m, v [n], the rows' places and
// g in both orders [B] each, dense_part [blocks, d_pad], loss_part [blocks], each
// on 256 bytes.
size_t lr_compact_workspace_bytes(long long B, int n, int d_pad, int blocks) {
  return 2 * align256(sizeof(float) * n) + 2 * align256(sizeof(int) * B) +
         2 * align256(sizeof(float) * B) +
         align256(sizeof(float) * static_cast<size_t>(blocks) * d_pad) +
         align256(sizeof(float) * blocks);
}

// A whole compact run. uid, iid [B] int32 (id_bytes 4) or int64 (8); order_u,
// off_u = id_segments(uid, u_pad), order_i, off_i = id_segments(iid, i_pad)
// (int64); dense [B, d_pad], y [B], w0 [u_pad + i_pad + d_pad] f32; out: w [u_pad +
// i_pad + d_pad], losses [E] f32; workspace of lr_compact_workspace_bytes bytes;
// `blocks` must be resident at once (lr_compact_grid).
int lr_compact_train(const void* uid, const void* iid, const void* order_u, const void* off_u,
                     const void* order_i, const void* off_i, const void* dense, const void* y,
                     const void* w0, void* w, void* losses, void* workspace, long long B,
                     int u_pad, int i_pad, int d_pad, int E, float lr, float b1,
                     float one_minus_b1, float b2, float one_minus_b2, float eps, float log_b1,
                     float log_b2, int id_bytes, int blocks, void* stream) {
  if ((id_bytes != 4 && id_bytes != 8) || d_pad < 1 || d_pad > kMaxDense || B < 1 ||
      B > 0x7fffffffLL || u_pad < 1 || i_pad < 1 || E < 0 || blocks < 1) {
    return cudaErrorInvalidValue;
  }
  const int n = u_pad + i_pad + d_pad;
  char* ws = static_cast<char*>(workspace);
  CompactParams P{};
  P.ids[0] = uid;
  P.ids[1] = iid;
  P.order[0] = static_cast<const long long*>(order_u);
  P.order[1] = static_cast<const long long*>(order_i);
  P.off[0] = static_cast<const long long*>(off_u);
  P.off[1] = static_cast<const long long*>(off_i);
  P.dense = static_cast<const float*>(dense);
  P.y = static_cast<const float*>(y);
  P.w0 = static_cast<const float*>(w0);
  P.w = static_cast<float*>(w);
  auto take = [&ws](size_t bytes) {
    char* here = ws;
    ws += align256(bytes);
    return here;
  };
  P.m = reinterpret_cast<float*>(take(sizeof(float) * n));
  P.v = reinterpret_cast<float*>(take(sizeof(float) * n));
  for (int q = 0; q < 2; ++q) {
    P.rank[q] = reinterpret_cast<int*>(take(sizeof(int) * B));
    P.gs[q] = reinterpret_cast<float*>(take(sizeof(float) * B));
  }
  P.dense_part =
      reinterpret_cast<float*>(take(sizeof(float) * static_cast<size_t>(blocks) * d_pad));
  P.loss_part = reinterpret_cast<float*>(take(sizeof(float) * blocks));
  P.losses = static_cast<float*>(losses);
  P.B = B;
  P.u_pad = u_pad;
  P.i_pad = i_pad;
  P.d_pad = d_pad;
  P.E = E;
  P.id_bytes = id_bytes;
  const void* kernel = compact_kernel_for(d_pad);
  cudaError_t err = cudaSuccess;
  const size_t smem = compact_smem(kernel, d_pad, &err);
  if (err != cudaSuccess) return err;
  P.a = Adam{lr, b1, one_minus_b1, b2, one_minus_b2, eps, log_b1, log_b2};
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(kernel, blocks, kCompactThreads, args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error behind for the next launcher
    return err;
  }
  return cudaGetLastError();
}

}  // extern "C"
