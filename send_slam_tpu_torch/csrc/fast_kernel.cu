// FAST-16 corner score (+ optional fused 3x3 NMS) over every pyramid level
// of a frame (and every row of a batch) in one launch. CUDA C++ for sm_90a.
//
// Replaces the TPU kernel send_slam_tpu/ops/pallas/fast_kernel.py
// fast_score_map_pallas at both of its pallas_call sites: _call_single
// (one level per call, 8 calls per frame) and _call_batched (the
// custom_vmap rule: a leading batch axis). Same results as the plain
// version (send_slam_tpu_torch/ops/fast.py fast_score_map / nms3x3), bit
// for bit over the whole image, borders included:
//   d_j   = I(p + o_j) - I(p) over the 16 Bresenham-circle offsets o_j;
//   B     = max over the 16 arcs of the min of 9 consecutive d_j,
//   D     = max over the 16 arcs of the min of 9 consecutive -d_j;
//   raw   = max(B, D) where the pixel is a corner (a circular run of 9
//           with d > th or with d < -th), else 0;
//   nms   = raw where it beats its 3x3 neighbours (>= the earlier ones in
//           raster order, > the later ones), else 0; a neighbour outside
//           the image counts as -inf.
//
// Bound on an H100 SXM (the 8 levels of a 640x480 frame, 930,525 pixels):
// memory moves 12 B per pixel (image in, raw and NMS out), 11.2 MB or
// 3.33 us at 3.35 TB/s. The operations depend on the data: every pixel
// takes 4 subtractions and 8 compares (the pre-test below) and one NMS
// select; a pixel that passes the pre-test 12 more subtractions and 161
// min/max/compare/select; a corner 8 NMS compares. A subtraction issues
// at 128 per clock per SM, a min, max, compare or select at 64
// (throughput table for compute capability 9.0), so the min/max side
// bounds it: 6.6 us on chip_smoke.py's noisy texture, where two thirds
// of the pixels pass the pre-test (chip_smoke.py counts them and prints
// the bound); the kernel takes 23 us there (H100 80GB HBM3, 700 W).
// What the design does:
//
// 1. One launch for all levels and batch rows. The levels travel by value
//    in a __grid_constant__ table (<= 16 entries: pointers, H, W, tiles
//    across, first tile). A 1-D grid runs over the concatenated tile list
//    of all levels and blockIdx.y over the batch; a block finds its level
//    by scanning the table's prefix. The small levels, which alone cost a
//    launch's ramp and tail each, now fill the waves of the large ones.
// 2. Fewer operations per pixel, all exact (min, max, compare, negate and
//    one subtraction per circle point; no rounding anywhere):
//    - compass pre-test: any circular run of 9 of the 16 points holds two
//      neighbouring points of {0, 4, 8, 12}; a pixel with no such bright
//      or dark pair cannot be a corner and scores 0;
//    - warp vote: a warp in which no lane passes the pre-test skips the
//      16-point work (__any_sync);
//    - the corner test comes from the score itself: a bright run of 9
//      exists iff B > th, a dark one iff D > th, so raw = max(B, D) where
//      max(B, D) > th (no bit masks, no run test);
//    - arcs by doubling, the plain version's 1-2-4-8+1 chain: 4 x 16 mins
//      per side instead of 8 x 16;
//    - the dark side as D = -(min over arcs of the max over the arc of d),
//      without 16 negations.
//    Signed zeros cannot differ: a score reaches the output only when it
//    is > th >= 0 (the wrapper refuses a negative threshold).
// 3. Register blocking: a thread scores R vertically adjacent pixels of
//    one column, loading the 7-column window of the circle once into
//    registers (10 + 4 x 8 + 2 x 6 = 54 shared loads for R = 4, against
//    68 one pixel at a time). The tile is TW x TH; with NMS the block
//    also scores the 1-pixel ring around it (1.09x the pixels at 64x32
//    against 1.20x at a 32x16 tile) and keeps the scores in shared memory.
// 4. Staging. A tile whose halo lies inside the image loads its rows with
//    16-byte vector loads (aligned down, the extra elements dropped); only
//    tiles that touch an image edge take the clamped scalar path, which is
//    the edge replication the plain version's padding gives. TMA is not
//    used: its out-of-bounds fill is zero, not edge replication, and the
//    kernel is not bound by the 3.3 us of memory traffic.
//
// Shape: a 64x32 tile (FAST_TILE_W x FAST_TILE_H, passed by
// ops/fast_cuda.py, which computes the tile table from the same
// constants), runs of R = 4, 256 threads, >= 2 blocks per SM. nvcc
// -Xptxas -v on the card (CUDA 12.8): 118 registers, 20,496 B shared, no
// spills. It was chosen on an NVIDIA H100 80GB HBM3 at 700 W among five
// shapes timed in one run (device ms per 640x480 frame, PERF.md section
// 6): 64x32 R 4 at 256 threads 0.0229; 64x16 R 4 at 128 threads 0.0235;
// 32x32 R 4 at 128 threads 0.0230; 64x32 R 2 at 512 threads 0.0259;
// 64x32 R 4 at >= 3 blocks/SM 0.0225 but 76 B spilled, so not kept.
// At 118 registers a SM holds 16 warps; a block's duration is one
// thread's serial work (~9 pixels), which is why one launch over all
// levels beats one launch per level by 3x at the same per-pixel code.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#if !defined(FAST_TILE_W) || !defined(FAST_TILE_H)
#error "build with -DFAST_TILE_W=... -DFAST_TILE_H=... (ops/fast_cuda.py)"
#endif

constexpr int kMaxLevels = 16;
constexpr int HALO = 4;  // 3 for the circle + 1 for the NMS ring
constexpr int TW = FAST_TILE_W, TH = FAST_TILE_H;  // the tile
constexpr int R = 4;        // pixels per thread, one column
constexpr int NT = 256;     // threads per block
constexpr int MINB = 2;     // blocks per SM the registers must allow

struct Level {
  const float* in;  // (B, H, W)
  float* raw;       // (B, H, W)
  float* nms;       // (B, H, W), or null for raw only
  int H, W;
  int tiles_x;      // tiles across the level
  int tile0;        // the level's first tile in the launch's tile list
};

struct Table {
  Level lv[kMaxLevels];
  int n_levels;
  float th;
};

// Bresenham circle radius 3, OpenCV order (clockwise from the top):
// dx = 0 1 2 3 3 3 2 1 0 -1 -2 -3 -3 -3 -2 -1, dy = dx of (j + 12) mod 16.
__host__ __device__ constexpr int cdx(int j) {
  return j < 4 ? j : j < 6 ? 3 : j < 12 ? 8 - j : j < 14 ? -3 : j - 16;
}
__host__ __device__ constexpr int cdy(int j) { return cdx((j + 12) & 15); }

// Scores of N vertically adjacent pixels; s points at the first pixel's
// centre in the staged tile (row stride ld). live[r] false: the pixel is
// outside the image and is not a candidate (its score is not used).
template <int N>
__device__ __forceinline__ void score_run(const float* __restrict__ s, int ld,
                                          float th, const bool (&live)[N],
                                          float (&out)[N]) {
  // The 7 columns around the run, rows -3 .. N + 2. Only the entries the
  // circle reads survive dead-code elimination.
  float v[N + 6][7];
#pragma unroll
  for (int i = 0; i < N + 6; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) v[i][j] = s[(i - 3) * ld + (j - 3)];

  const float nth = -th;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const float c = v[r + 3][3];
    float d[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) d[j] = v[r + 3 + cdy(j)][3 + cdx(j)] - c;
    const bool b0 = d[0] > th, b4 = d[4] > th, b8 = d[8] > th,
               b12 = d[12] > th;
    const bool k0 = d[0] < nth, k4 = d[4] < nth, k8 = d[8] < nth,
               k12 = d[12] < nth;
    const bool cand = live[r] && ((b0 && b4) || (b4 && b8) || (b8 && b12) ||
                                  (b12 && b0) || (k0 && k4) || (k4 && k8) ||
                                  (k8 && k12) || (k12 && k0));
    float score = 0.0f;
    if (__any_sync(0xffffffffu, cand)) {
      float lo[16], hi[16], lo2[16], hi2[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        lo[j] = fminf(d[j], d[(j + 1) & 15]);   // arcs of 2
        hi[j] = fmaxf(d[j], d[(j + 1) & 15]);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        lo2[j] = fminf(lo[j], lo[(j + 2) & 15]);  // arcs of 4
        hi2[j] = fmaxf(hi[j], hi[(j + 2) & 15]);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        lo[j] = fminf(lo2[j], lo2[(j + 4) & 15]);  // arcs of 8
        hi[j] = fmaxf(hi2[j], hi2[(j + 4) & 15]);
      }
      float best = fminf(lo[0], d[8]);   // arcs of 9: max of the mins
      float worst = fmaxf(hi[0], d[8]);  // and min of the maxes
#pragma unroll
      for (int j = 1; j < 16; ++j) {
        best = fmaxf(best, fminf(lo[j], d[(j + 8) & 15]));
        worst = fminf(worst, fmaxf(hi[j], d[(j + 8) & 15]));
      }
      const float m = fmaxf(best, -worst);
      score = (cand && m > th) ? m : 0.0f;
    }
    out[r] = score;
  }
}

// Stage the tile plus a HALO-pixel border into s_in (SH x SW).
__device__ __forceinline__ void stage(float* __restrict__ s_in,
                                      const float* __restrict__ img, int H,
                                      int W, int x0, int y0) {
  constexpr int SW = TW + 2 * HALO, SH = TH + 2 * HALO;
  const bool interior = x0 >= HALO && y0 >= HALO && x0 + TW + HALO <= W &&
                        y0 + TH + HALO <= H;
  if (interior) {
    // 16-byte loads from the row's start aligned down; a float4 that
    // holds a needed element lies inside the image's allocation.
    constexpr int NV = SW / 4 + 1;
    for (int i = threadIdx.x; i < SH * NV; i += NT) {
      const int sy = i / NV, k = i - (i / NV) * NV;
      const float* row = img + (size_t)(y0 - HALO + sy) * W + (x0 - HALO);
      const int sh = (int)((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
      const int e0 = 4 * k - sh;
      if (e0 >= SW) continue;
      const float4 q = __ldg(reinterpret_cast<const float4*>(row - sh) + k);
      float* dst = s_in + sy * SW;
      if (sh == 0) {
        *reinterpret_cast<float4*>(dst + e0) = q;
      } else {
        const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (e0 + c >= 0 && e0 + c < SW) dst[e0 + c] = e[c];
      }
    }
  } else {
    for (int i = threadIdx.x; i < SH * SW; i += NT) {
      const int sy = i / SW, sx = i - (i / SW) * SW;
      const int gy = min(max(y0 - HALO + sy, 0), H - 1);
      const int gx = min(max(x0 - HALO + sx, 0), W - 1);
      s_in[i] = __ldg(img + (size_t)gy * W + gx);
    }
  }
}

__global__ void __launch_bounds__(NT, MINB)
    fast_levels_kernel(const __grid_constant__ Table t) {
  static_assert(TW % 32 == 0 && TH % R == 0, "tile shape");
  static_assert((TW * (TH / R)) % NT == 0 && NT % 32 == 0, "work split");
  constexpr int SW = TW + 2 * HALO, SH = TH + 2 * HALO;
  constexpr int RW = TW + 2, RH = TH + 2;  // scored region with the ring
  constexpr int NITEMS = TW * (TH / R);    // (column, run) work items
  __shared__ __align__(16) float s_in[SH * SW];
  __shared__ float s_raw[RH * RW];

  int l = 0;
  while (l + 1 < t.n_levels && (int)blockIdx.x >= t.lv[l + 1].tile0) ++l;
  const Level& L = t.lv[l];
  const int H = L.H, W = L.W;
  const int tile = blockIdx.x - L.tile0;
  const int x0 = (tile % L.tiles_x) * TW, y0 = (tile / L.tiles_x) * TH;
  const size_t plane = (size_t)blockIdx.y * H * W;
  const float th = t.th;
  float* raw = L.raw + plane;
  float* nms = L.nms == nullptr ? nullptr : L.nms + plane;

  stage(s_in, L.in + plane, H, W, x0, y0);
  __syncthreads();

  // Body: each item is R rows of one column. NITEMS is a multiple of NT,
  // so every lane of a warp runs each iteration (the vote needs that).
  for (int it = threadIdx.x; it < NITEMS; it += NT) {
    const int c = it % TW, ty = (it / TW) * R;
    const int gx = x0 + c, gy = y0 + ty;
    bool live[R];
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) live[r] = gx < W && gy + r < H;
    score_run<R>(s_in + (ty + HALO) * SW + c + HALO, SW, th, live, sc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (live[r]) raw[(size_t)(gy + r) * W + gx] = sc[r];
      if (nms != nullptr)
        s_raw[(ty + r + 1) * RW + c + 1] = live[r] ? sc[r] : -INFINITY;
    }
  }
  if (nms == nullptr) return;

  // The 1-pixel ring around the tile, one pixel per lane; the count is
  // rounded up to whole warps and the extra lanes score nothing.
  constexpr int NRING = 2 * RW + 2 * TH;
  constexpr int NRING_W = (NRING + 31) / 32 * 32;
  for (int it = threadIdx.x; it < NRING_W; it += NT) {
    const int i = it < NRING ? it : 0;
    int ry, rx;
    if (i < RW) {
      ry = 0, rx = i;
    } else if (i < 2 * RW) {
      ry = RH - 1, rx = i - RW;
    } else if (i < 2 * RW + TH) {
      ry = 1 + i - 2 * RW, rx = 0;
    } else {
      ry = 1 + i - 2 * RW - TH, rx = RW - 1;
    }
    const int gy = y0 - 1 + ry, gx = x0 - 1 + rx;
    const bool live[1] = {it < NRING && gy >= 0 && gy < H && gx >= 0 &&
                          gx < W};
    float sc[1];
    score_run<1>(s_in + (ry + HALO - 1) * SW + rx + HALO - 1, SW, th, live,
                 sc);
    if (it < NRING) s_raw[ry * RW + rx] = live[0] ? sc[0] : -INFINITY;
  }
  __syncthreads();

  // NMS over the body, the same items; a 3 x (R + 2) window of scores.
  for (int it = threadIdx.x; it < NITEMS; it += NT) {
    const int c = it % TW, ty = (it / TW) * R;
    const int gx = x0 + c, gy = y0 + ty;
    float w[R + 2][3];
#pragma unroll
    for (int i = 0; i < R + 2; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) w[i][j] = s_raw[(ty + i) * RW + c + j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!(gx < W && gy + r < H)) continue;
      const float v = w[r + 1][1];
      const bool keep = v >= w[r][0] && v >= w[r][1] && v >= w[r][2] &&
                        v >= w[r + 1][0] && v > w[r + 1][2] &&
                        v > w[r + 2][0] && v > w[r + 2][1] && v > w[r + 2][2];
      nms[(size_t)(gy + r) * W + gx] = keep ? v : 0.0f;
    }
  }
}

}  // namespace

// One launch over n_levels levels of a batch of `batch` images.
//   ptrs: 3 * n_levels device pointers: the inputs, the raw outputs, the
//         NMS outputs (all null for raw only), each (batch, H, W) f32;
//   dims: 4 * n_levels ints: H, W, tiles across and first tile per level
//         (the tile table, checked here against the TW x TH tile);
//   n_tiles: the tile count of all levels together.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int fast_score_levels(int n_levels, int batch,
                                 void* const* ptrs, const int* dims,
                                 int n_tiles, float threshold, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || batch < 1 || batch > 65535 ||
      !(threshold >= 0.0f))
    return (int)cudaErrorInvalidValue;
  const bool with_nms = ptrs[2 * n_levels] != nullptr;
  Table t;
  t.n_levels = n_levels;
  t.th = threshold;
  long long next = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int H = dims[4 * l], W = dims[4 * l + 1];
    const int tx = dims[4 * l + 2], t0 = dims[4 * l + 3];
    if (H < 1 || W < 1 || tx != (W + TW - 1) / TW || t0 != next ||
        ptrs[l] == nullptr || ptrs[n_levels + l] == nullptr ||
        (ptrs[2 * n_levels + l] != nullptr) != with_nms)
      return (int)cudaErrorInvalidValue;
    next += (long long)tx * ((H + TH - 1) / TH);
    t.lv[l] = Level{static_cast<const float*>(ptrs[l]),
                    static_cast<float*>(ptrs[n_levels + l]),
                    static_cast<float*>(ptrs[2 * n_levels + l]), H, W, tx,
                    t0};
  }
  if (next != n_tiles) return (int)cudaErrorInvalidValue;
  dim3 grid(n_tiles, batch);
  fast_levels_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
