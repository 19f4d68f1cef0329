// Full-batch MF training for Hopper (sm_90a), the whole run in one persistent
// cooperative launch, with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel deeplearningrecommendationsystem_tpu/ops/pallas/
// mf_epoch.py::mf_fullbatch_train (_kernel): a whole MF run of full-batch epochs,
// each one the gathers of both factor tables, the BCE loss, its one-hot backward
// and a torch-Adam step (L2 before the moments) on f32 master weights, with the
// forward and backward in float32 or bfloat16. Its plain PyTorch version is
// mf_fullbatch_train_plain in deeplearningrecommendationsystem_tpu_torch/ops/mf_epoch.py.
//
// The Pallas kernel keeps the tables and the Adam moments in VMEM across a grid
// (epochs, row_blocks) that the TPU runs in order. Here mf_train_kernel is one
// cooperative launch a call (cudaLaunchCooperativeKernel, every block resident),
// whose phases are separated by grid barriers (cooperative_groups grid.sync()):
//
// prologue: permute the rows into user order and into item order (ops/segments.py
// builds both orders and their segment offsets once a call: the ids do not change
// across epochs), copy the masters, zero the moments and, in the bf16 variant,
// write a bf16 copy of each table. Barrier.
//
// each epoch, the gradient phase: the two orders are cut into chunks of kChunk
// positions, and warp w takes chunks w, w + warps, ... of both (a fixed
// assignment; the next chunk's positions are loaded while the warp works on
// this one). In the user pass a warp holds the user's factor row in registers
// and gathers only item rows; the item pass holds the item row and gathers user
// rows. Lane l holds kCols values of a row (2, 4, 8 or 16, the fewest that cover
// D, so D <= 512): pairs of adjacent columns where D is even (a row is one float2
// or bf16x2 load a lane per 64 columns), else (odd D) columns l, l + 32, ...,
// 16 of them. A warp takes a chunk in groups of kR = 16 / kCols rows (one row
// past D 256) in two register buffers: the next group's gathers are in flight
// while it sums this one. It sums a group's dot products by recursive halving
// (reduce_rows: the butterfly's sums, one row to a group of lanes), so that each
// row's sigmoid and loss run on 32 / kR lanes, not 32, and broadcasts g =
// (sigmoid(z) - y) / B back for the gradient rows g * other_row (rounded to bf16
// in the bf16 variant, then summed in f32), summed over the rows of each segment
// that fall in the chunk. The held rows of the chunk's first and last segments
// are read before its first group; a segment that starts and ends inside the
// chunk (rare) takes a path of its own. Both passes compute z with the same lane
// mapping and the same reduction, so the item pass's z and g are the user pass's
// bit for bit and the passes need no barrier between them. A segment that lies
// in one chunk is written to gsum; one that spans chunks leaves each chunk's part
// in a slot of that chunk (slot_a: the segment holds the chunk's first position,
// else slot_b). No atomics: every sum has a fixed order. The loss is summed over
// the user pass (every row once) per warp, per block in warp order, into
// loss_part. Barrier.
//
// each epoch, the Adam phase: one thread a master value sums its row's gradient
// (gsum, or the chunks' slots in chunk order; 0 for an id with no row), applies
// torch Adam with L2 (dw = d + wd p; m, v; bias corrections 1 - exp(t log b) as
// the Pallas kernel computes them) and, in the bf16 variant, rewrites the copy
// (the master rounded to bf16, what the Pallas kernel's astype reads), so the
// next epoch gathers half the bytes. Warp 0 of block 0 writes the epoch's loss,
// the block partials summed in a fixed order, over B. Barrier.
//
// An id outside [0, V) matches no row, as the Pallas one-hot mask matches none:
// its embedding is zero and it adds no gradient (it lies in no segment). The
// result depends on the grid size (the loss's order of summation), which is
// fixed for a card, and on nothing else: two calls give the same bits.
//
// Bound: bytes of the whole call (uid, iid, y and the two tables read once, the
// tables and losses written once) against about 6D + 20 operations a row and 15
// a table value an epoch: a few microseconds. What the call pays is the L2 and
// the chains of each warp's work: each epoch gathers every row's item row and
// user row once (2 x 229,350 rows x 256 B = 117 MB at the MF preset in f32, half
// in bf16), and a warp's chunk is a chain of gathers, shuffles and the sigmoid
// (PERF.md, section 6, says where the time goes), plus two grid barriers an epoch.
//
// The entry point returns the launch's cudaError_t (or one for arguments it does
// not take); the Python launcher raises when it is not 0. A grid that cannot be
// resident (cudaErrorCooperativeLaunchTooLarge) is such an error.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;           // positions of an order a warp takes at a time
constexpr int kMaxColsPerLane = 16;  // D <= 512: 2, 4, 8 or 16 columns a lane
constexpr unsigned kFull = 0xffffffffu;

struct Adam {
  float lr, wd, b1, one_minus_b1, b2, one_minus_b2, eps, log_b1, log_b2;
};

// One pass: the rows in the order of the held table's ids.
struct Pass {
  const long long* order;  // [B] row at each position (ops/segments.py::id_segments)
  const long long* off;    // [V + 1] segment offsets
  int* seg;                // [B] the held id at each position, -1 out of range
  int* other;              // [B] the other table's id at each position, -1 out of range
  float* y;                // [B] the label at each position
  float* gsum;             // [V, D] a segment's gradient where it lies in one chunk
  float* slot_a;           // [chunks, D] a chunk's part of the segment holding its first position
  float* slot_b;           // [chunks, D] its part of the segment that starts inside it and runs on
};

struct Params {
  const void* ids[2];      // uid, iid: int32 (id_bytes 4) or int64 (8)
  const float* y;
  const float* p0[2];      // the initial masters
  float* p[2];             // the masters: pu, pi
  float* m[2];
  float* v[2];
  unsigned short* copy[2];  // bf16 copies of the masters (the bf16 variant)
  Pass pass[2];            // 0: user order (holds user rows), 1: item order
  float* loss_part;        // [gridDim.x]
  float* losses;           // [E]
  long long B;
  int V[2];
  int D, E, chunks, id_bytes;
  Adam a;
};

// Id r of an int32 (id_bytes 4) or int64 (8) id array.
__device__ __forceinline__ long long load_id(const void* ids, int id_bytes, long long r) {
  return id_bytes == 8 ? __ldg(static_cast<const long long*>(ids) + r)
                       : static_cast<long long>(__ldg(static_cast<const int*>(ids) + r));
}

template <bool kBf16>
__device__ __forceinline__ float compute(float x) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ float bce(float z, float y) {
  return fmaxf(z, 0.f) - z * y + log1pf(expf(-fabsf(z)));
}

// Column of a lane's k-th value: lane l holds kVec adjacent columns at kVec l,
// kVec (l + 32), ... (kCols values), so that a row is read with one load of
// kVec values a lane per 32 kVec columns.
template <int kVec>
__device__ __forceinline__ int col_of(int lane, int k) {
  return kVec * (lane + 32 * (k / kVec)) + k % kVec;
}

// Row `row` of a table as the forward reads it (zeros for row < 0): the master
// (float32) or its bf16 copy, kVec values a load. Both are written inside the
// launch, so the loads go to L2 (.cg), never through a cache that a grid
// barrier does not keep coherent.
template <bool kBf16, int kVec, int kCols>
__device__ __forceinline__ void load_row(const float* master, const unsigned short* copy, int row,
                                         int D, int lane, float (&out)[kCols]) {
#pragma unroll
  for (int g = 0; g < kCols / kVec; ++g) {
    const int col = col_of<kVec>(lane, kVec * g);
    const size_t j = static_cast<size_t>(row) * D + col;
    float x[kVec];
#pragma unroll
    for (int t = 0; t < kVec; ++t) x[t] = 0.f;
    if (row >= 0 && col < D) {  // D is even where kVec is 2
      if constexpr (kVec == 2 && kBf16) {
        const unsigned w = __ldcg(reinterpret_cast<const unsigned*>(copy + j));
        x[0] = __uint_as_float(w << 16);
        x[1] = __uint_as_float(w & 0xffff0000u);
      } else if constexpr (kVec == 2) {
        const float2 w = __ldcg(reinterpret_cast<const float2*>(master + j));
        x[0] = w.x;
        x[1] = w.y;
      } else if constexpr (kBf16) {
        x[0] = __uint_as_float(static_cast<unsigned>(__ldcg(copy + j)) << 16);
      } else {
        x[0] = __ldcg(master + j);
      }
    }
#pragma unroll
    for (int t = 0; t < kVec; ++t) out[kVec * g + t] = x[t];
  }
}

// Where a chunk's sum over the rows of segment s goes (s >= 0): gsum when the
// segment lies in the chunk, else the chunk's slot_a when the segment holds the
// chunk's first position, else its slot_b. Whether the segment runs on before or
// after the chunk is read off the positions around it (before, after: their
// segments), so the flush reads no offsets.
struct ChunkEdges {
  int first, last;     // the segments of the chunk's first and last positions
  int before, after;   // the segments of the positions just before and after it (-2: none)
};

template <int kVec, int kCols>
__device__ __forceinline__ void flush(const Pass& ps, int s, long long c, const ChunkEdges& ed,
                                      int D, int lane, const float (&acc)[kCols]) {
  if (s < 0) return;
  const bool split = (s == ed.first && ed.before == s) || (s == ed.last && ed.after == s);
  float* dst = !split ? ps.gsum + static_cast<size_t>(s) * D
                      : (s == ed.first ? ps.slot_a : ps.slot_b) + static_cast<size_t>(c) * D;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int col = col_of<kVec>(lane, k);
    if (col < D) dst[col] = acc[k];
  }
}

__host__ __device__ constexpr int log2_of(int x) { return x <= 1 ? 0 : 1 + log2_of(x / 2); }

// One step of reduce_rows: at width kWidth the lanes with that bit set keep the
// upper kHalf of their rows and the others the lower kHalf, each adding its
// partner's value of the row it keeps; then the next step, down to one row.
template <int kHalf, int kWidth, int kN>
__device__ __forceinline__ void halve(float (&part)[kN], int lane) {
  if constexpr (kHalf >= 1) {
    const bool upper = lane & kWidth;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float keep = upper ? part[i + kHalf] : part[i];
      const float send = upper ? part[i] : part[i + kHalf];
      part[i] = keep + __shfl_xor_sync(kFull, send, kWidth);
    }
    halve<kHalf / 2, kWidth / 2, kN>(part, lane);
  }
}

// The sums over the warp of kR rows' partial dot products, by recursive halving
// (halve) down to one row a lane, then a butterfly over the remaining widths.
// Every row's sum is the full butterfly's, term for term (a + b and b + a are
// the same float), so it does not depend on the row's place among the kR.
// Returns the sum of row (lane >> (5 - log2 kR)).
template <int kR>
__device__ __forceinline__ float reduce_rows(float (&part)[kR], int lane) {
  halve<kR / 2, 16, kR>(part, lane);
  float z = part[0];
#pragma unroll
  for (int width = 16 / kR; width > 0; width >>= 1) z += __shfl_xor_sync(kFull, z, width);
  return z;
}

// A chunk's per-position data, one position a lane: its segment, the other
// table's id and the label; lanes 0 and 1 also the segments just before and
// just after the chunk. Loaded one task ahead of its use.
struct ChunkMeta {
  int seg, other, edge;
  float y;
};

__device__ __forceinline__ ChunkMeta load_meta(const Pass& ps, long long c, long long B, int lane) {
  const long long p0 = c * kChunk;
  const long long p1 = min(B, p0 + kChunk);
  const bool in = p0 + lane < p1;
  ChunkMeta m;
  m.seg = in ? __ldcg(ps.seg + p0 + lane) : -1;
  m.other = in ? __ldcg(ps.other + p0 + lane) : -1;
  m.y = in ? __ldcg(ps.y + p0 + lane) : 0.f;
  m.edge = lane == 0 ? (p0 > 0 ? __ldcg(ps.seg + p0 - 1) : -2)
                     : (lane == 1 && p1 < B ? __ldcg(ps.seg + p1) : -2);
  return m;
}

template <int kCols>
__device__ __forceinline__ float dot(const float (&h)[kCols], const float (&o)[kCols]) {
  float part = 0.f;
#pragma unroll
  for (int k = 0; k < kCols; ++k) part = fmaf(h[k], o[k], part);
  return part;
}

// What a warp carries through a chunk: the held rows of its first and last
// segments, and (kMixed) of a segment inside it; the gradient sums.
template <int kCols>
struct ChunkSums {
  float h_first[kCols], h_last[kCols], h_mid[kCols], acc_first[kCols], acc_last[kCols];
  int mid, acc_seg;
};

template <int kCols>
__device__ __forceinline__ void start_chunk(ChunkSums<kCols>& cs) {
  cs.mid = -2;
  cs.acc_seg = -1;
#pragma unroll
  for (int k = 0; k < kCols; ++k) cs.h_mid[k] = cs.acc_first[k] = cs.acc_last[k] = 0.f;
}

// Rows of a group: kRowsOf<kCols> x kCols = 16 gathered values a lane.
template <int kCols>
constexpr int kRowsOf = kCols >= 16 ? 1 : 16 / kCols;

// kR = kRowsOf<kCols> rows of a chunk at positions j0, ... (their other rows in
// ov): their z by reduce_rows; each row's sigmoid and
// loss on the lanes that hold its z (32 / kR of them); g broadcast back to the
// warp for the gradient sums. A chunk holds one or two segments but where a
// segment starts and ends inside it: then (kMixed) a third held row, read from
// L2, and the sums are kept segment by segment.
template <bool kBf16, int kVec, int kCols, bool kMixed>
__device__ __forceinline__ void sum_rows(const Pass& ps, const ChunkMeta& m, const ChunkEdges& ed,
                                         ChunkSums<kCols>& cs,
                                         const float (&ov)[kRowsOf<kCols>][kCols],
                                         int j0, int n, const float* held_p,
                                         const unsigned short* held_c, int D, float nb,
                                         long long c, bool want_loss, float& loss, int lane) {
  constexpr int kR = kRowsOf<kCols>;       // rows: 8, 4, 2 or 1
  constexpr int kShift = 5 - log2_of(kR);  // lane >> kShift: the row a lane sums
  const int rq = lane >> kShift;
  const bool owner = (lane & ((1 << kShift) - 1)) == 0;  // one lane a row adds its loss
  int s[kR];
  float part[kR];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    s[q] = __shfl_sync(kFull, m.seg, j0 + q);
    if (s[q] == ed.first) {  // the same on every lane
      part[q] = dot(cs.h_first, ov[q]);
    } else {
      part[q] = dot(cs.h_last, ov[q]);
    }
    if constexpr (kMixed) {
      if (s[q] != ed.first && s[q] != ed.last) {  // the same on every lane
        if (s[q] != cs.mid) {
          cs.mid = s[q];
          load_row<kBf16, kVec, kCols>(held_p, held_c, cs.mid, D, lane, cs.h_mid);
        }
        part[q] = dot(cs.h_mid, ov[q]);
      }
    }
  }
  const float z = reduce_rows<kR>(part, lane);  // row rq's, the same in both passes
  const int sr = __shfl_sync(kFull, m.seg, j0 + rq);
  const float yr = __shfl_sync(kFull, m.y, j0 + rq);
  const bool live = j0 + rq < n;
  if (want_loss && live && owner) loss += bce(z, yr);
  const float g = live && sr >= 0 ? (1.f / (1.f + expf(-z)) - yr) / nb : 0.f;
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    const float gq = __shfl_sync(kFull, g, q << kShift);  // 0 past the chunk or for id -1
    if constexpr (kMixed) {
      if (j0 + q >= n || s[q] < 0) continue;
      if (s[q] != cs.acc_seg) {
        flush<kVec>(ps, cs.acc_seg, c, ed, D, lane, cs.acc_first);
        cs.acc_seg = s[q];
#pragma unroll
        for (int k = 0; k < kCols; ++k) cs.acc_first[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kCols; ++k) cs.acc_first[k] += compute<kBf16>(gq * ov[q][k]);
    } else if (s[q] == ed.first) {  // the same on every lane
#pragma unroll
      for (int k = 0; k < kCols; ++k) cs.acc_first[k] += compute<kBf16>(gq * ov[q][k]);
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k) cs.acc_last[k] += compute<kBf16>(gq * ov[q][k]);
    }
  }
}

template <int kVec, int kCols, bool kMixed>
__device__ __forceinline__ void finish_chunk(const Pass& ps, long long c, const ChunkEdges& ed,
                                             ChunkSums<kCols>& cs, int D, int lane) {
  if constexpr (kMixed) {
    flush<kVec>(ps, cs.acc_seg, c, ed, D, lane, cs.acc_first);
  } else {
    flush<kVec>(ps, ed.first, c, ed, D, lane, cs.acc_first);
    if (ed.last != ed.first) flush<kVec>(ps, ed.last, c, ed, D, lane, cs.acc_last);
  }
}

__device__ __forceinline__ ChunkEdges edges_of(const ChunkMeta& m, int n) {
  return ChunkEdges{__shfl_sync(kFull, m.seg, 0), __shfl_sync(kFull, m.seg, n - 1),
                    __shfl_sync(kFull, m.edge, 0), __shfl_sync(kFull, m.edge, 1)};
}

// Whether the chunk holds a segment that starts and ends inside it.
__device__ __forceinline__ bool mixed_of(const ChunkMeta& m, const ChunkEdges& ed, int n,
                                         int lane) {
  return __any_sync(kFull, lane < n && m.seg != ed.first && m.seg != ed.last);
}

// Chunk c of a pass, its rows gathered by the warp's own loads, a group of kR
// rows at a time in two register buffers: the next group's gathers are in flight
// while the warp sums this one; the held rows of the chunk's first and last
// segments are read before the first group.
template <bool kBf16, int kVec, int kCols, bool kMixed>
__device__ __forceinline__ void gather_chunk(const Pass& ps, const ChunkMeta& m,
                                             const ChunkEdges& ed, const float* held_p,
                                             const unsigned short* held_c, const float* other_p,
                                             const unsigned short* other_c, int D, float nb,
                                             long long c, int n, bool want_loss, float& loss,
                                             int lane) {
  constexpr int kR = kRowsOf<kCols>;
  ChunkSums<kCols> cs;
  start_chunk(cs);
  load_row<kBf16, kVec, kCols>(held_p, held_c, ed.first, D, lane, cs.h_first);
  if (ed.last != ed.first) {
    load_row<kBf16, kVec, kCols>(held_p, held_c, ed.last, D, lane, cs.h_last);
  } else {
#pragma unroll
    for (int k = 0; k < kCols; ++k) cs.h_last[k] = cs.h_first[k];
  }
  const auto gather = [&](float (&ov)[kR][kCols], int j0) {
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const int s = __shfl_sync(kFull, m.seg, (j0 + q) & 31);
      const int o = __shfl_sync(kFull, m.other, (j0 + q) & 31);
      load_row<kBf16, kVec, kCols>(other_p, other_c, s >= 0 ? o : -1, D, lane, ov[q]);
    }
  };
  const auto sum = [&](const float (&ov)[kR][kCols], int j0) {
    sum_rows<kBf16, kVec, kCols, kMixed>(ps, m, ed, cs, ov, j0, n, held_p, held_c, D, nb, c,
                                         want_loss, loss, lane);
  };
  float ova[kR][kCols], ovb[kR][kCols];
  gather(ova, 0);
  for (int j0 = 0; j0 < n; j0 += 2 * kR) {
    if (j0 + kR < n) gather(ovb, j0 + kR);
    sum(ova, j0);
    if (j0 + kR >= n) break;
    if (j0 + 2 * kR < n) gather(ova, j0 + 2 * kR);
    sum(ovb, j0 + kR);
  }
  finish_chunk<kVec, kCols, kMixed>(ps, c, ed, cs, D, lane);
}

template <bool kBf16, int kVec, int kCols>
__device__ __forceinline__ void gather_chunk(const Pass& ps, const ChunkMeta& m,
                                             const float* held_p, const unsigned short* held_c,
                                             const float* other_p, const unsigned short* other_c,
                                             int D, float nb, long long c, long long B,
                                             bool want_loss, float& loss, int lane) {
  const int n = static_cast<int>(min(B, c * kChunk + kChunk) - c * kChunk);
  const ChunkEdges ed = edges_of(m, n);
  if (mixed_of(m, ed, n, lane)) {
    gather_chunk<kBf16, kVec, kCols, true>(ps, m, ed, held_p, held_c, other_p, other_c, D, nb, c,
                                           n, want_loss, loss, lane);
  } else {
    gather_chunk<kBf16, kVec, kCols, false>(ps, m, ed, held_p, held_c, other_p, other_c, D, nb, c,
                                            n, want_loss, loss, lane);
  }
}

// The gradient of value (s, col) of a pass's table: its segment's sum, the
// chunks' parts added in chunk order (loaded eight at a time).
__device__ __forceinline__ float segment_grad(const Pass& ps, int s, int col, int D) {
  const long long a = __ldg(ps.off + s), b = __ldg(ps.off + s + 1);
  if (b <= a) return 0.f;
  const long long c0 = a / kChunk, c1 = (b - 1) / kChunk;
  if (c0 == c1) return __ldcg(ps.gsum + static_cast<size_t>(s) * D + col);
  float g = 0.f;
  for (long long c = c0; c <= c1; c += 8) {
    float x[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const long long ct = c + t;
      x[t] = ct <= c1 ? __ldcg((a <= ct * kChunk ? ps.slot_a : ps.slot_b) +
                               static_cast<size_t>(ct) * D + col)
                      : 0.f;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (c + t <= c1) g += x[t];
    }
  }
  return g;
}

template <bool kBf16, int kVec, int kCols>
__global__ void __launch_bounds__(kThreads) mf_train_kernel(Params P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float lossw[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;
  const long long gwarp = tid >> 5, nwarps = nthreads >> 5;
  const long long B = P.B;
  const int D = P.D;

#pragma unroll 4
  for (long long t = tid; t < 2 * B; t += nthreads) {
    const int q = t >= B;
    const long long pos = t - q * B;
    const long long r = __ldg(P.pass[q].order + pos);
    const long long h = load_id(P.ids[q], P.id_bytes, r);
    const long long o = load_id(P.ids[1 - q], P.id_bytes, r);
    P.pass[q].seg[pos] = (h >= 0 && h < P.V[q]) ? static_cast<int>(h) : -1;
    P.pass[q].other[pos] = (o >= 0 && o < P.V[1 - q]) ? static_cast<int>(o) : -1;
    P.pass[q].y[pos] = __ldg(P.y + r);
  }
  const long long nu = static_cast<long long>(P.V[0]) * D;
  const long long nall = nu + static_cast<long long>(P.V[1]) * D;
  // every value of the masters and moments is written and read by one thread:
  // the prologue's mapping is the Adam phase's
  for (long long j = tid; j < nall; j += nthreads) {
    const int q = j >= nu;
    const long long jj = j - q * nu;
    const float x = __ldg(P.p0[q] + jj);
    P.p[q][jj] = x;
    P.m[q][jj] = 0.f;
    P.v[q][jj] = 0.f;
    if constexpr (kBf16) P.copy[q][jj] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  grid.sync();

  const float nb = static_cast<float>(B);
  const long long tasks = 2LL * P.chunks;
  const Adam& a = P.a;
  for (int e = 0; e < P.E; ++e) {
    float loss = 0.f;
    ChunkMeta next{};
    if (gwarp < tasks) {
      const int q = gwarp >= P.chunks;
      next = load_meta(P.pass[q], gwarp - q * P.chunks, B, lane);
    }
    for (long long t = gwarp; t < tasks; t += nwarps) {
      const int q = t >= P.chunks;
      const ChunkMeta m = next;
      if (t + nwarps < tasks) {  // the next task's data, in flight during this one
        const int qn = t + nwarps >= P.chunks;
        next = load_meta(P.pass[qn], t + nwarps - qn * P.chunks, B, lane);
      }
      gather_chunk<kBf16, kVec, kCols>(P.pass[q], m, P.p[q], P.copy[q], P.p[1 - q], P.copy[1 - q],
                                       D, nb, t - q * P.chunks, B, q == 0, loss, lane);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) loss += __shfl_xor_sync(kFull, loss, off);
    if (lane == 0) lossw[warp] = loss;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += lossw[w];
      P.loss_part[blockIdx.x] = s;
    }
    grid.sync();

    if (blockIdx.x == 0 && warp == 0) {
      float s = 0.f;
      for (unsigned b = lane; b < gridDim.x; b += 32) s += __ldcg(P.loss_part + b);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
      if (lane == 0) P.losses[e] = s / nb;
    }
    const float t = static_cast<float>(e + 1);
    const float bc1 = 1.f - expf(t * a.log_b1);
    const float bc2 = 1.f - expf(t * a.log_b2);
    for (long long j = tid; j < nall; j += nthreads) {
      const int q = j >= nu;
      const long long jj = j - q * nu;
      const int s = static_cast<int>(jj / D);
      const int col = static_cast<int>(jj - static_cast<long long>(s) * D);
      const float d = segment_grad(P.pass[q], s, col, D);
      float* p = P.p[q];
      const float dw = d + a.wd * p[jj];
      const float mj = a.b1 * P.m[q][jj] + a.one_minus_b1 * dw;
      const float vj = a.b2 * P.v[q][jj] + a.one_minus_b2 * dw * dw;
      const float pn = p[jj] - a.lr * (mj / bc1) / (sqrtf(vj / bc2) + a.eps);
      p[jj] = pn;
      P.m[q][jj] = mj;
      P.v[q][jj] = vj;
      if constexpr (kBf16) P.copy[q][jj] = __bfloat16_as_ushort(__float2bfloat16_rn(pn));
    }
    if (e + 1 < P.E) grid.sync();
  }
}

// The kernel for D and the dtype: the fewest values a lane that cover D, in pairs
// of columns a load where D is even; odd D reads one column a load, 16 a lane.
template <bool kBf16>
const void* kernel_for(int D) {
  if (D % 2 != 0) return reinterpret_cast<const void*>(mf_train_kernel<kBf16, 1, 16>);
  return D <= 64    ? reinterpret_cast<const void*>(mf_train_kernel<kBf16, 2, 2>)
         : D <= 128 ? reinterpret_cast<const void*>(mf_train_kernel<kBf16, 2, 4>)
         : D <= 256 ? reinterpret_cast<const void*>(mf_train_kernel<kBf16, 2, 8>)
                    : reinterpret_cast<const void*>(mf_train_kernel<kBf16, 2, 16>);
}

const void* kernel_for(int D, int bf16) {
  return bf16 ? kernel_for<true>(D) : kernel_for<false>(D);
}

// The workspace's pieces, each on 256 bytes.
struct Layout {
  size_t at = 0;
  size_t take(size_t bytes) {
    const size_t here = at;
    at += (bytes + 255) & ~static_cast<size_t>(255);
    return here;
  }
};

long long chunks_of(long long B) { return (B + kChunk - 1) / kChunk; }

}  // namespace

extern "C" {

int mf_epoch_max_dim() { return 32 * kMaxColsPerLane; }

const char* mf_epoch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blocks of mf_train_kernel that the current device keeps resident at once for
// this D and dtype (bf16 0 or 1): the SM count times the blocks an SM holds. 0
// on an error.
int mf_train_grid(int D, int bf16) {
  int dev = 0, sms = 0, fit = 0;
  if (D < 1 || D > 32 * kMaxColsPerLane ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel_for(D, bf16), kThreads, 0) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return sms * fit;
}

// Bytes of the workspace mf_train needs.
size_t mf_train_workspace_bytes(long long B, int U, int I, int D, int blocks) {
  Layout l;
  const long long chunks = chunks_of(B);
  for (const int V : {U, I}) {
    const size_t table = sizeof(float) * static_cast<size_t>(V) * D;
    l.take(sizeof(int) * B);                             // seg
    l.take(sizeof(int) * B);                             // other
    l.take(sizeof(float) * B);                           // y
    l.take(table);                                       // gsum
    l.take(sizeof(float) * static_cast<size_t>(chunks) * D);  // slot_a
    l.take(sizeof(float) * static_cast<size_t>(chunks) * D);  // slot_b
    l.take(table);                                       // m
    l.take(table);                                       // v
    l.take(sizeof(unsigned short) * static_cast<size_t>(V) * D);  // copy
  }
  l.take(sizeof(float) * blocks);                         // loss_part
  return l.at;
}

// A whole run: uid, iid [B] int32 (id_bytes 4) or int64 (8); y [B] f32; pu0
// [U, D], pi0 [I, D] f32; order_u, off_u = id_segments(uid, U), order_i, off_i =
// id_segments(iid, I) (int64); out: pu [U, D], pi [I, D], losses [E] f32;
// workspace of mf_train_workspace_bytes(B, U, I, D, blocks) bytes; `blocks` must
// be resident at once (mf_train_grid).
int mf_train(const void* uid, const void* iid, const void* y, const void* pu0, const void* pi0,
             const void* order_u, const void* off_u, const void* order_i, const void* off_i,
             void* pu, void* pi, void* losses, void* workspace, long long B, int U, int I, int D,
             int E, float lr, float wd, float b1, float one_minus_b1, float b2,
             float one_minus_b2, float eps, float log_b1, float log_b2, int bf16, int id_bytes,
             int blocks, void* stream) {
  if ((id_bytes != 4 && id_bytes != 8) || B < 1 || B > 0x7fffffffLL || U < 1 || I < 1 ||
      D < 1 || D > 32 * kMaxColsPerLane || E < 0 || blocks < 1 ||
      (static_cast<long long>(U) + I) * D > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  auto* ws = static_cast<char*>(workspace);
  Layout l;
  const long long chunks = chunks_of(B);
  Params P{};
  const void* ids[2] = {uid, iid};
  const void* orders[2] = {order_u, order_i};
  const void* offs[2] = {off_u, off_i};
  const void* p0[2] = {pu0, pi0};
  void* p[2] = {pu, pi};
  const int V[2] = {U, I};
  for (int q = 0; q < 2; ++q) {
    const size_t table = sizeof(float) * static_cast<size_t>(V[q]) * D;
    Pass& ps = P.pass[q];
    ps.order = static_cast<const long long*>(orders[q]);
    ps.off = static_cast<const long long*>(offs[q]);
    ps.seg = reinterpret_cast<int*>(ws + l.take(sizeof(int) * B));
    ps.other = reinterpret_cast<int*>(ws + l.take(sizeof(int) * B));
    ps.y = reinterpret_cast<float*>(ws + l.take(sizeof(float) * B));
    ps.gsum = reinterpret_cast<float*>(ws + l.take(table));
    const size_t slots = sizeof(float) * static_cast<size_t>(chunks) * D;
    ps.slot_a = reinterpret_cast<float*>(ws + l.take(slots));
    ps.slot_b = reinterpret_cast<float*>(ws + l.take(slots));
    P.m[q] = reinterpret_cast<float*>(ws + l.take(table));
    P.v[q] = reinterpret_cast<float*>(ws + l.take(table));
    P.copy[q] = reinterpret_cast<unsigned short*>(
        ws + l.take(sizeof(unsigned short) * static_cast<size_t>(V[q]) * D));
    P.ids[q] = ids[q];
    P.p0[q] = static_cast<const float*>(p0[q]);
    P.p[q] = static_cast<float*>(p[q]);
    P.V[q] = V[q];
  }
  P.loss_part = reinterpret_cast<float*>(ws + l.take(sizeof(float) * blocks));
  P.y = static_cast<const float*>(y);
  P.losses = static_cast<float*>(losses);
  P.B = B;
  P.D = D;
  P.E = E;
  P.chunks = static_cast<int>(chunks);
  P.id_bytes = id_bytes;
  P.a = Adam{lr, wd, b1, one_minus_b1, b2, one_minus_b2, eps, log_b1, log_b2};
  void* args[] = {&P};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel_for(D, bf16), blocks, kThreads, args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error behind for the next launcher
    return err;
  }
  return cudaGetLastError();
}

}  // extern "C"
