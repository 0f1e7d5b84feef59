// Order-fixed segment sums in one launch: send_slam_tpu_torch/ops/segsum.py
// fixed_order_sum (every form ObsMap reads) on the card. CUDA C++ for sm_90a.
//
// Replaces no Pallas kernel. The JAX package's ObsMap
// (send_slam_tpu/ops/segsum.py) assembles the BA with XLA's one-hot matmul or
// segment_sum. The kernel is added for the card's time: the plain version
// sorts the whole (R, D) block by value, sorts it again by segment and hands
// torch.segment_reduce n_seg + 1 segments. PyTorch gives one thread to each
// (segment, column) there, and the last segment, the spill slot, holds every
// invalid observation of the window (62,000 of the wide window's 64,000 rows,
// 254,000 of the global window's 256,000): D threads add it row after row on
// every call, and the result is dropped.
//
// The contract is the plain version's bits: out[s, d] is column d's values
// over the rows of segment s, in ascending order, added left to right from
// +0.0f. The sum depends only on the multiset of values, so the order of the
// rows and the tie order of equal values (+0 and -0 among them) do not
// matter; the accumulator starts at +0, so a sum of zeros is +0. Built
// without fast math: denormals add as PyTorch's kernel adds them.
//
// Bound on an H100 SXM: bytes. A call reads its valid rows' values once and
// writes the (n_seg, D) output, which the caller zeroes (torch.zeros) so that
// empty segments read +0; the BA's segments hold 1-8 rows, so the sorts are
// a few dozen register operations a (segment, column). What the design does:
//
// 1. The index (ops/segsum.py segment_index, built once per segment map on
//    the device): perm, the valid rows stably sorted by segment (-1 for the
//    spill rows); offsets, where each segment starts in perm (the last entry
//    is the number of valid rows); the segments longer than SEGSUM_SHORT rows
//    (long_seg, n_long). No spill row is read, and the host reads nothing.
// 2. Short segments (every BA segment): a thread per (position in perm,
//    column). The thread at a segment's first position loads the segment's
//    values through perm into registers, padded with +inf to 1, 2, 4, 8, 16
//    or 32, sorts them with a bitonic network and adds them. Adjacent threads
//    take adjacent columns of one row, so the loads of a row-major block and
//    the stores into the row-major output coalesce.
// 3. Long segments (the pose graph's blocks that many edges share): a block
//    per (segment, column). The column's values go to shared memory, or to
//    the caller's global scratch past SEGSUM_SMEM_ROWS rows, so that no
//    length is refused; the block sorts them with a bitonic network and one
//    thread adds them.
// 4. Every comparator of both networks puts the smaller value at the lower
//    index, so the padding past a segment's end acts as +inf without being
//    stored (the block network skips the comparators that reach past it),
//    and swaps only when x > y: a NaN never moves, stays inside its segment
//    and makes the sum NaN, as in the plain version.
// 5. The grid is at most 8 blocks per SM; each block first takes its share
//    of the long (segment, column) pairs, then strides over the short ones.
//    Segment lengths come from offsets on the device, so one launch serves
//    every caller and shape.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef SEGSUM_SHORT
#define SEGSUM_SHORT 32
#endif
#ifndef SEGSUM_SMEM_ROWS
#define SEGSUM_SMEM_ROWS 4096
#endif

namespace {

constexpr int NT = 256;                       // threads a block
constexpr int kShort = SEGSUM_SHORT;          // rows a thread sorts
constexpr int kSmemRows = SEGSUM_SMEM_ROWS;   // rows a block sorts in shared
static_assert(kShort >= 1 && kShort <= 32, "SEGSUM_SHORT must be 1..32");

struct Args {
  const float* values;    // row r = b * rows_per_block + k, column d at
                          // b * sb + k * sr + d * sd
  const int64_t* seg;     // (R,) segment id of each row, n_seg = spill
  const int64_t* perm;    // (R,) valid rows by segment, then -1
  const int64_t* offsets; // (n_seg + 1,)
  const int64_t* long_seg;  // segments of more than kShort rows
  const int64_t* n_long;    // () their number
  float* out;             // (n_seg, D) row-major, zeroed by the caller
  float* scratch;         // R * D floats, or null when R <= kSmemRows
  int64_t n_seg, rows_per_block, sb, sr, sd;
  int d;
};

__device__ __forceinline__ float load(const Args& a, int64_t row, int col) {
  const int64_t b = row / a.rows_per_block;
  const int64_t k = row - b * a.rows_per_block;
  return a.values[b * a.sb + k * a.sr + col * a.sd];
}

__device__ __forceinline__ void order(float& x, float& y) {
  if (x > y) {
    const float t = x;
    x = y;
    y = t;
  }
}

// Sum of a segment's len <= 2^LOG values of one column, ascending, from +0.
template <int LOG>
__device__ __forceinline__ float short_sum(const Args& a, int64_t start,
                                           int len, int col) {
  constexpr int N = 1 << LOG;
  float v[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    v[k] = k < len ? load(a, a.perm[start + k], col) : INFINITY;
#pragma unroll
  for (int lk = 1; lk <= LOG; ++lk) {
    const int k = 1 << lk, h = k >> 1;
#pragma unroll
    for (int t = 0; t < N / 2; ++t)
      order(v[(t / h) * k + t % h], v[(t / h) * k + k - 1 - t % h]);
#pragma unroll
    for (int lm = lk - 2; lm >= 0; --lm) {
      const int m = 1 << lm;
#pragma unroll
      for (int t = 0; t < N / 2; ++t)
        order(v[(t / m) * 2 * m + t % m], v[(t / m) * 2 * m + t % m + m]);
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < len) acc += v[k];
  return acc;
}

__device__ __forceinline__ float short_sum_any(const Args& a, int64_t start,
                                               int len, int col) {
  if (len <= 1) return short_sum<0>(a, start, len, col);
  if (len <= 2) return short_sum<1>(a, start, len, col);
  if (len <= 4) return short_sum<2>(a, start, len, col);
  if (len <= 8) return short_sum<3>(a, start, len, col);
  if (len <= 16) return short_sum<4>(a, start, len, col);
  return short_sum<5>(a, start, len, col);
}

// Sorts v[0, n) ascending with the whole block: a bitonic network over the
// next power of two, its comparators past n skipped.
__device__ void block_sort(float* v, int64_t n) {
  int64_t p = 1;
  while (p < n) p <<= 1;
  for (int64_t k = 2; k <= p; k <<= 1) {
    const int64_t h = k >> 1;
    for (int64_t t = threadIdx.x; t < p / 2; t += NT) {
      const int64_t base = (t / h) * k, off = t % h;
      if (base + k - 1 - off < n) order(v[base + off], v[base + k - 1 - off]);
    }
    __syncthreads();
    for (int64_t m = k >> 2; m >= 1; m >>= 1) {
      for (int64_t t = threadIdx.x; t < p / 2; t += NT) {
        const int64_t i = (t / m) * 2 * m + t % m;
        if (i + m < n) order(v[i], v[i + m]);
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(NT) segsum_kernel(const Args a) {
  __shared__ float buf[kSmemRows];
  // Long segments: a block per (segment, column).
  const int64_t n_long = *a.n_long * a.d;
  for (int64_t k = blockIdx.x; k < n_long; k += gridDim.x) {
    const int64_t s = a.long_seg[k / a.d];
    const int col = (int)(k % a.d);
    const int64_t start = a.offsets[s];
    const int64_t n = a.offsets[s + 1] - start;
    float* v = n <= kSmemRows ? buf : a.scratch + start * a.d + col * n;
    for (int64_t t = threadIdx.x; t < n; t += NT)
      v[t] = load(a, a.perm[start + t], col);
    __syncthreads();
    block_sort(v, n);
    if (threadIdx.x == 0) {
      float acc = 0.0f;
      for (int64_t t = 0; t < n; ++t) acc += v[t];
      a.out[s * a.d + col] = acc;
    }
    __syncthreads();
  }
  // Short segments: a thread per (position in perm, column); the thread at
  // a segment's first position sums it.
  const int64_t items = a.offsets[a.n_seg] * a.d;
  for (int64_t q = (int64_t)blockIdx.x * NT + threadIdx.x; q < items;
       q += (int64_t)gridDim.x * NT) {
    const int64_t i = q / a.d;
    const int col = (int)(q - i * a.d);
    const int64_t s = a.seg[a.perm[i]];
    const int64_t start = a.offsets[s];
    if (start != i) continue;
    const int64_t len = a.offsets[s + 1] - start;
    if (len > kShort) continue;
    a.out[s * a.d + col] = short_sum_any(a, start, (int)len, col);
  }
}

}  // namespace

extern "C" int segsum(int64_t n_rows, int d, int64_t rows_per_block,
                      int64_t sb, int64_t sr, int64_t sd, const void* values,
                      const void* seg, const void* perm, const void* offsets,
                      const void* long_seg, const void* n_long, int64_t n_seg,
                      void* out, void* scratch, void* stream) {
  if (n_rows < 0 || d < 0 || n_seg < 0 || rows_per_block < 1 ||
      offsets == nullptr || n_long == nullptr || long_seg == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n_rows > 0 && (values == nullptr || seg == nullptr || perm == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_seg > 0 && d > 0 && out == nullptr) return (int)cudaErrorInvalidValue;
  if (n_rows > kSmemRows && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(values),
               static_cast<const int64_t*>(seg),
               static_cast<const int64_t*>(perm),
               static_cast<const int64_t*>(offsets),
               static_cast<const int64_t*>(long_seg),
               static_cast<const int64_t*>(n_long),
               static_cast<float*>(out),
               static_cast<float*>(scratch),
               n_seg, rows_per_block, sb, sr, sd, d};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t work = (n_rows * d + NT - 1) / NT;
  const int grid = (int)(work < 1 ? 1 : work < 8 * sms ? work : 8 * sms);
  segsum_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
