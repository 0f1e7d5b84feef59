// Robust pose-only Gauss-Newton in one launch: every round and iteration of
// send_slam_tpu_torch/models/tracking.py pose_only_gn on the card. CUDA C++
// for sm_90a.
//
// Replaces no Pallas kernel. The JAX package leaves this loop to XLA
// (send_slam_tpu/models/tracking.py:79, a lax.scan at :129), which fuses it
// into a few programs; the port ran it op by op, ~1,500 launches for a
// 2 x 5 call and ~2,900 for a 4 x 5 call, each of which the host took
// ~20 us to issue while the card finished it in a microsecond or two.
// Here the whole call is one launch. It computes, as the plain version does:
//   p      = R X + t;  z = max(p_z, 1e-6);  (u, v) = (fx p_x / z + cx,
//            fy p_y / z + cy);  J the 2 x 6 Jacobian of (u, v) in a left
//            increment exp(delta) T, delta = (rho, phi);
//   r      = (u, v) - uv_obs;  chi2 = |r|^2 / sigma2;
//   w      = [valid & inlier & p_z > 1e-3] * min(huber_delta /
//            sqrt(max(chi2, 1e-12)), 1) / sigma2;
//   H      = sum w J^T J + 1e-6 I,  b = sum w J^T r,  delta = -H^-1 b,
//   (R, t) <- exp(delta) (R, t)  (se3_exp with geometry/se3.py's
//            small-angle selections: theta^2 < 1e-8);
// `iters` times a round, then inlier = valid & chi2 < 5.991 & p_z > 1e-3;
// `rounds` rounds; then the sum over the inliers of min(chi2, 5.991) and
// their count. No point has weight: H = 1e-6 I, b = 0, the update is 0.
//
// Bound on an H100 SXM: latency, not bytes or operations. A call is
// rounds x iters dependent steps (30 a frame on the main path, 2 x 5 and
// 4 x 5; 40 for relocalization's 4 x 10), each a pass over the points, a
// block-wide reduction of 27 sums and a serial 6 x 6 solve. The data is
// ~28 B a point, ~35 KB at N = 1,250: 0.01 us at 3.35 TB/s; the operations
// (~150 a point and step) 0.2 us at 67 TFLOP/s over a whole 4 x 5 call.
// What the design does:
//
// 1. One block of 256 threads. Thread k owns the points k, k + 256, ... in
//    every pass, so its inlier flags need no synchronisation. X, uv_obs,
//    sigma2 and the valid and inlier flags are read from device memory in
//    every pass, where they stay in L1 and L2, for every N. Staging them in
//    shared memory saved 0.0035 ms of a 1,000-point 2 x 5 call and 0.0114
//    ms of a 1,250-point 4 x 5 call on an H100, less than the 0.06-0.10 ms
//    the host takes to issue a call, and nothing at 16,384 points, so the
//    kernel has one path.
// 2. Per step, each thread sums the 21 upper-triangle entries of H and the
//    6 of b over its points in float32, the plain version's precision for
//    the per-point products; the block's sums are taken in float64: a warp
//    reduce-scatter with shuffles (31 double shuffles a warp, not 27 x 5),
//    then the 8 warps' partials in a fixed order. No atomics: the same
//    inputs give the same bits.
// 3. Thread 0 keeps the pose in float64 across steps, solves the 6 x 6
//    system by Gaussian elimination with partial pivoting (the plain
//    version's LU), applies se3_exp and composes in float64, and publishes
//    the pose rounded to float32 through shared memory for the next pass.
//    Two block barriers a step.
// 4. The last pass sums min(chi2, 5.991) over the inliers in float64 and
//    counts them; the outputs (R, t, chi2, n_inliers) go to one 16-float
//    buffer, the inlier flags to their own.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads, one block
constexpr int NW = NT / 32;        // warps
constexpr int NACC = 27;           // H's upper triangle (21) and b (6)
constexpr float kChi2 = 5.991f;    // CHI2_2DOF
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* R0;        // (3, 3) row-major
  const float* t0;        // (3,)
  const float* X;         // (n, 3)
  const float* uv;        // (n, 2)
  const uint8_t* valid;   // (n,) 0 / 1
  const float* sigma2;    // (n,), or null for ones
  const float* cam;       // fx, fy, cx, cy on the device, or null: by value
  float* out;             // (16,): R (9), t (3), chi2, n_inliers (int32)
  uint8_t* inlier;        // (n,) 0 / 1
  int n, rounds, iters;
  float fx, fy, cx, cy, huber_delta;
};

struct Point {
  float x, y, z, is2, u, v;
};

__device__ __forceinline__ Point load_point(const Args& a, int i) {
  const float* x = a.X + 3 * (size_t)i;
  return Point{__ldg(x), __ldg(x + 1), __ldg(x + 2),
               a.sigma2 == nullptr ? 1.0f : 1.0f / __ldg(a.sigma2 + i),
               __ldg(a.uv + 2 * (size_t)i), __ldg(a.uv + 2 * (size_t)i + 1)};
}

// p = R X + t with R row-major in P[0..8] and t in P[9..11].
__device__ __forceinline__ void transform(const float (&P)[12], const Point& q,
                                          float& px, float& py, float& pz) {
  px = q.x * P[0] + q.y * P[1] + q.z * P[2] + P[9];
  py = q.x * P[3] + q.y * P[4] + q.z * P[5] + P[10];
  pz = q.x * P[6] + q.y * P[7] + q.z * P[8] + P[11];
}

// |r|^2 / sigma2 at the pose; pz is the point's depth.
__device__ __forceinline__ float chi2_at(const float (&P)[12], const Point& q,
                                         float fx, float fy, float cx, float cy,
                                         float& pz) {
  float px, py;
  transform(P, q, px, py, pz);
  const float iz = 1.0f / fmaxf(pz, 1e-6f);
  const float r0 = fx * px * iz + cx - q.u, r1 = fy * py * iz + cy - q.v;
  return (r0 * r0 + r1 * r1) * q.is2;
}

// One step of a reduce-scatter over a warp: a lane keeps the W values
// its lane bit W selects and sends the other W to its partner.
template <int W>
__device__ __forceinline__ void scatter_step(double (&v)[32], int lane) {
  const bool hi = (lane & W) != 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const double send = hi ? v[j] : v[j + W];
    const double keep = hi ? v[j + W] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, W);
  }
}

// Reduce-scatter of 32 values over a warp: lane l ends with the warp's sum
// of v[l] in v[0].
__device__ __forceinline__ void warp_reduce_scatter(double (&v)[32], int lane) {
  scatter_step<16>(v, lane);
  scatter_step<8>(v, lane);
  scatter_step<4>(v, lane);
  scatter_step<2>(v, lane);
  scatter_step<1>(v, lane);
}

// delta = -H^-1 b from the 27 sums (H's upper triangle row by row, then
// b), with 1e-6 added to H's diagonal: Gaussian elimination with partial
// pivoting, all in registers.
__device__ __forceinline__ void solve6(const double* s, double (&delta)[6]) {
  double A[6][7];
  int q = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = s[q];
      A[j][i] = s[q];
      ++q;
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    A[i][i] += (double)1e-6f;
    A[i][6] = s[21 + i];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    // Bring the largest |A[i][k]|, i >= k, to row k (the first on ties).
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const bool swap = fabs(A[i][k]) > fabs(A[k][k]);
#pragma unroll
      for (int j = k; j < 7; ++j) {
        const double hi = A[k][j], lo = A[i][j];
        A[k][j] = swap ? lo : hi;
        A[i][j] = swap ? hi : lo;
      }
    }
    const double inv = 1.0 / A[k][k];
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const double f = A[i][k] * inv;
#pragma unroll
      for (int j = k + 1; j < 7; ++j) A[i][j] -= f * A[k][j];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    double acc = A[i][6];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) acc -= A[i][j] * delta[j];
    delta[i] = acc / A[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) delta[i] = -delta[i];
}

// (R, t) <- exp(delta) (R, t), delta = (rho, phi), as geometry/se3.py's
// se3_exp and se3_compose compute it, in float64.
__device__ __forceinline__ void apply_exp(const double (&d)[6], double (&R)[9],
                                          double (&t)[3]) {
  const double x = d[3], y = d[4], z = d[5];
  const double theta = sqrt(x * x + y * y + z * z + 1e-24);
  const double t2 = theta * theta;
  const bool small = t2 < 1e-8;
  double sn, cs;
  sincos(theta, &sn, &cs);
  const double A = small ? 1.0 - t2 / 6.0 : sn / theta;
  const double B = small ? 0.5 - t2 / 24.0 : (1.0 - cs) / t2;
  const double C = small ? 1.0 / 6.0 - t2 / 120.0 : (theta - sn) / (t2 * theta);
  const double K[9] = {0.0, -z, y, z, 0.0, -x, -y, x, 0.0};
  double K2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      K2[3 * i + j] = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] +
                      K[3 * i + 2] * K[6 + j];
  double dR[9], V[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const double I = (k % 4 == 0) ? 1.0 : 0.0;
    dR[k] = I + A * K[k] + B * K2[k];
    V[k] = I + B * K[k] + C * K2[k];
  }
  double Rn[9], tn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Rn[3 * i + j] = dR[3 * i] * R[j] + dR[3 * i + 1] * R[3 + j] +
                      dR[3 * i + 2] * R[6 + j];
    tn[i] = dR[3 * i] * t[0] + dR[3 * i + 1] * t[1] + dR[3 * i + 2] * t[2] +
            (V[3 * i] * d[0] + V[3 * i + 1] * d[1] + V[3 * i + 2] * d[2]);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = tn[k];
}

__global__ void __launch_bounds__(NT, 1) pose_gn_kernel(const __grid_constant__ Args a) {
  __shared__ double s_red[NW][NACC];
  __shared__ double s_tot[32];
  __shared__ float s_pose[12];
  __shared__ int s_cnt[NW];

  const int n = a.n, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* valid = a.valid;
  uint8_t* inl = a.inlier;

  float fx = a.fx, fy = a.fy, cx = a.cx, cy = a.cy;
  if (a.cam != nullptr) {
    fx = __ldg(a.cam), fy = __ldg(a.cam + 1);
    cx = __ldg(a.cam + 2), cy = __ldg(a.cam + 3);
  }
  const float hd = a.huber_delta;

  // Thread 0 carries the pose in float64 from start to end.
  double R[9], t[3];
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      R[k] = a.R0[k];
      s_pose[k] = a.R0[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      t[k] = a.t0[k];
      s_pose[9 + k] = a.t0[k];
    }
  }
  // inlier starts as valid.
  for (int i = tid; i < n; i += NT) inl[i] = valid[i] != 0;
  __syncthreads();

  float P[12];
  for (int round = 0; round < a.rounds; ++round) {
    for (int it = 0; it < a.iters; ++it) {
#pragma unroll
      for (int k = 0; k < 12; ++k) P[k] = s_pose[k];
      float acc[NACC];
#pragma unroll
      for (int k = 0; k < NACC; ++k) acc[k] = 0.0f;
      for (int i = tid; i < n; i += NT) {
        if (!inl[i]) continue;  // inlier implies valid
        const Point q = load_point(a, i);
        float px, py, pz;
        transform(P, q, px, py, pz);
        if (!(pz > 1e-3f)) continue;
        const float iz = 1.0f / fmaxf(pz, 1e-6f);
        const float r0 = fx * px * iz + cx - q.u;
        const float r1 = fy * py * iz + cy - q.v;
        const float chi2 = (r0 * r0 + r1 * r1) * q.is2;
        const float nrm = sqrtf(fmaxf(chi2, 1e-12f));
        const float w = fminf(hd * (1.0f / nrm), 1.0f) * q.is2;
        if (w == 0.0f) continue;
        const float a0 = fx * iz, c0 = -fx * px * iz * iz;
        const float b1 = fy * iz, d1 = -fy * py * iz * iz;
        const float J0[6] = {a0, 0.0f, c0, c0 * py, a0 * pz - c0 * px, -a0 * py};
        const float J1[6] = {0.0f, b1, d1, d1 * py - b1 * pz, -d1 * px, b1 * px};
        float w0[6], w1[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          w0[k] = w * J0[k];
          w1[k] = w * J1[k];
        }
        int q2 = 0;
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int c = r; c < 6; ++c) acc[q2++] += w0[r] * J0[c] + w1[r] * J1[c];
#pragma unroll
        for (int r = 0; r < 6; ++r) acc[21 + r] += w0[r] * r0 + w1[r] * r1;
      }
      double v[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) v[k] = k < NACC ? (double)acc[k] : 0.0;
      warp_reduce_scatter(v, lane);
      if (lane < NACC) s_red[warp][lane] = v[0];
      __syncthreads();
      if (warp == 0) {
        double tot = 0.0;
        if (lane < NACC)
#pragma unroll
          for (int w = 0; w < NW; ++w) tot += s_red[w][lane];
        s_tot[lane] = tot;
        __syncwarp();
        if (lane == 0) {
          double delta[6];
          solve6(s_tot, delta);
          apply_exp(delta, R, t);
#pragma unroll
          for (int k = 0; k < 9; ++k) s_pose[k] = (float)R[k];
#pragma unroll
          for (int k = 0; k < 3; ++k) s_pose[9 + k] = (float)t[k];
        }
      }
      __syncthreads();
    }
    // Reclassify: inlier = valid & chi2 < 5.991 & p_z > 1e-3.
#pragma unroll
    for (int k = 0; k < 12; ++k) P[k] = s_pose[k];
    for (int i = tid; i < n; i += NT) {
      uint8_t ok = 0;
      if (valid[i]) {
        float pz;
        const float chi2 =
            chi2_at(P, load_point(a, i), fx, fy, cx, cy, pz);
        ok = chi2 < kChi2 && pz > 1e-3f;
      }
      inl[i] = ok;
    }
  }

  // The clamped chi2 sum and the count over the inliers, at the final pose.
#pragma unroll
  for (int k = 0; k < 12; ++k) P[k] = s_pose[k];
  double csum = 0.0;
  int cnt = 0;
  for (int i = tid; i < n; i += NT) {
    if (!inl[i]) continue;
    float pz;
    const float chi2 = chi2_at(P, load_point(a, i), fx, fy, cx, cy, pz);
    csum += (double)fminf(chi2, kChi2);
    ++cnt;
  }
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    csum += __shfl_xor_sync(kFull, csum, w);
    cnt += __shfl_xor_sync(kFull, cnt, w);
  }
  // s_red is free: the last step's reads of it ended at its barrier.
  if (lane == 0) {
    s_red[warp][0] = csum;
    s_cnt[warp] = cnt;
  }
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    int c = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      s += s_red[w][0];
      c += s_cnt[w];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) a.out[k] = (float)R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) a.out[9 + k] = (float)t[k];
    a.out[12] = (float)s;
    reinterpret_cast<int*>(a.out)[13] = c;
  }
}

}  // namespace

// One launch of the whole Gauss-Newton on `stream`. Pointers are device
// pointers (row-major, contiguous); sigma2 null means ones; cam null means
// the intrinsics by value, else 4 floats on the device (fx, fy, cx, cy).
// out: 16 floats, R (9) t (3) chi2 (1) then n_inliers as an int32.
// Returns cudaGetLastError() (0 = launched).
extern "C" int pose_gn(int n, int rounds, int iters, const void* R0,
                       const void* t0, const void* X, const void* uv,
                       const void* valid, const void* sigma2, const void* cam,
                       float fx, float fy, float cx, float cy, float huber_delta,
                       void* out, void* inlier, void* stream) {
  if (n < 0 || rounds < 0 || iters < 0 || R0 == nullptr || t0 == nullptr ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n > 0 && (X == nullptr || uv == nullptr || valid == nullptr ||
                inlier == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(R0), static_cast<const float*>(t0),
               static_cast<const float*>(X), static_cast<const float*>(uv),
               static_cast<const uint8_t*>(valid),
               static_cast<const float*>(sigma2),
               static_cast<const float*>(cam), static_cast<float*>(out),
               static_cast<uint8_t*>(inlier), n, rounds, iters, fx, fy, cx, cy,
               huber_delta};
  pose_gn_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
