// FAST-16 corner score (+ optional fused 3x3 NMS), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel send_slam_tpu/ops/pallas/fast_kernel.py:
// fast_score_map_pallas (-> _call_single/_kernel and
// _call_batched/_kernel_batched, body _fast_tile). Same arithmetic as the
// plain version (send_slam_tpu_torch/ops/fast.py fast_score_map / nms3x3):
//   d_j = I(p + o_j) - I(p) over the 16 Bresenham-circle offsets o_j,
//   corner = circular run >= 9 in the bright (d > th) or dark (d < -th)
//            16-bit mask,
//   score  = max over the 16 arcs of min of 9 consecutive d (and of -d),
//            0 where not a corner;
//   nms    = score where it beats its 3x3 neighbours (>= the earlier ones
//            in raster order, > the later ones), else 0. A neighbour
//            outside the image counts as -inf, so the NMS map equals
//            nms3x3(score) over the WHOLE image.
// Only float subtractions, compares, mins and maxes: the results are
// bit-identical to the plain version.
//
// Bound on an H100 (the 8 pyramid levels of a 640x480 frame, 930,525
// pixels): memory moves 4 B in + 4 B raw + 4 B nms per pixel, ~11 MB or
// ~3.3 us at 3.35 TB/s; the arithmetic is ~424 operations per pixel
// (16 subtractions, 64 mask compares/ors, 22 run-test ops, 304 arc
// mins/maxes/negations, 16 NMS compares), ~3.9e8 per frame, ~5.9 us at
// 67 TFLOP/s fp32 (about 12 us at the one-instruction-per-lane issue
// rate). So the kernel is bound by arithmetic and by its 8 launches per
// frame, not by memory: the design keeps every operand in registers or
// shared memory and reads each input pixel from device memory once per
// block (plus a 4-pixel halo).
//
// Design (right and simple first): one thread per output pixel over a
// 32x16 tile; the block stages the tile plus a 4-pixel halo in shared
// memory with reads clamped to the image edge (the reference's edge
// padding); with NMS it scores a 1-pixel ring around the tile too, keeps
// those scores in shared memory and writes both maps in one pass.
// blockIdx.z runs over the batch (the batched Pallas variant). The Pallas
// tiling (32-row tiles, 128-lane widths, DMA double buffer) is a TPU
// alignment rule and is not carried over.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 32;             // tile width (output pixels)
constexpr int TH = 16;             // tile height
constexpr int HALO = 4;            // 3 for the circle + 1 for NMS
constexpr int SW = TW + 2 * HALO;  // staged input width
constexpr int SH = TH + 2 * HALO;
constexpr int RW = TW + 2;         // scored region with the NMS ring
constexpr int RH = TH + 2;

// Bresenham circle radius 3, OpenCV order (clockwise from the top).
__device__ __constant__ int kDX[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                       0, -1, -2, -3, -3, -3, -2, -1};
__device__ __constant__ int kDY[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                       3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ bool has_run9(int mask16) {
  int m = mask16 | (mask16 << 16);
  int r2 = m & (m >> 1);
  int r4 = r2 & (r2 >> 2);
  int r8 = r4 & (r4 >> 4);
  int r9 = r8 & (m >> 8);
  return (r9 & 0xFFFF) != 0;
}

// Score of the pixel staged at (sy, sx) of the shared input tile.
__device__ __forceinline__ float fast_pixel(const float (*s)[SW], int sy,
                                            int sx, float th) {
  const float c = s[sy][sx];
  float d[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) d[j] = s[sy + kDY[j]][sx + kDX[j]] - c;
  int bright = 0, dark = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    bright |= (d[j] > th) ? (1 << j) : 0;
    dark |= (d[j] < -th) ? (1 << j) : 0;
  }
  if (!(has_run9(bright) || has_run9(dark))) return 0.0f;
  float best_b = -INFINITY, best_d = -INFINITY;
#pragma unroll
  for (int st = 0; st < 16; ++st) {
    float mb = d[st], md = -d[st];
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      mb = fminf(mb, d[(st + k) & 15]);
      md = fminf(md, -d[(st + k) & 15]);
    }
    best_b = fmaxf(best_b, mb);
    best_d = fmaxf(best_d, md);
  }
  return fmaxf(best_b, best_d);
}

__global__ void fast_kernel(const float* __restrict__ in,
                            float* __restrict__ raw,
                            float* __restrict__ nms, int H, int W,
                            float th) {
  __shared__ float s_in[SH][SW];
  __shared__ float s_raw[RH][RW];

  const size_t plane = (size_t)H * W;
  const float* img = in + blockIdx.z * plane;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  // Stage the tile + halo, clamped to the image (edge padding).
  for (int i = tid; i < SH * SW; i += nthr) {
    int sy = i / SW, sx = i % SW;
    int gy = min(max(y0 - HALO + sy, 0), H - 1);
    int gx = min(max(x0 - HALO + sx, 0), W - 1);
    s_in[sy][sx] = img[(size_t)gy * W + gx];
  }
  __syncthreads();

  if (nms == nullptr) {
    for (int i = tid; i < TH * TW; i += nthr) {
      int ty = i / TW, tx = i % TW;
      int gy = y0 + ty, gx = x0 + tx;
      if (gy < H && gx < W)
        raw[blockIdx.z * plane + (size_t)gy * W + gx] =
            fast_pixel(s_in, ty + HALO, tx + HALO, th);
    }
    return;
  }

  // Scores on the tile plus a 1-pixel ring; outside the image -> -inf.
  for (int i = tid; i < RH * RW; i += nthr) {
    int ry = i / RW, rx = i % RW;
    int gy = y0 - 1 + ry, gx = x0 - 1 + rx;
    s_raw[ry][rx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                        ? fast_pixel(s_in, ry + HALO - 1, rx + HALO - 1, th)
                        : -INFINITY;
  }
  __syncthreads();

  for (int i = tid; i < TH * TW; i += nthr) {
    int ty = i / TW, tx = i % TW;
    int gy = y0 + ty, gx = x0 + tx;
    if (gy >= H || gx >= W) continue;
    const float c = s_raw[ty + 1][tx + 1];
    bool keep = true;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const float n = s_raw[ty + 1 + dy][tx + 1 + dx];
        const bool earlier = dy < 0 || (dy == 0 && dx < 0);
        keep = keep && (earlier ? (c >= n) : (c > n));
      }
    }
    const size_t o = blockIdx.z * plane + (size_t)gy * W + gx;
    raw[o] = c;
    nms[o] = keep ? c : 0.0f;
  }
}

}  // namespace

// in: (B, H, W) f32; raw, nms: (B, H, W) f32 outputs (nms may be null).
// Launches on ``stream`` and returns cudaGetLastError() (0 = launched).
extern "C" int fast_score(const float* in, float* raw, float* nms, int B,
                          int H, int W, float threshold, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  dim3 block(32, 8);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  fast_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(in, raw, nms, H, W,
                                                        threshold);
  return (int)cudaGetLastError();
}
