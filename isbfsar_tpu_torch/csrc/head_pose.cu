// Head pose from six face landmarks: the 40-iteration weak-perspective
// PnP of isbfsar_tpu/focus/geometry.py::head_pose_from_landmarks, one
// thread per frame, for sm_90a.
//
// It replaces no Pallas kernel: the JAX package leaves this solve to XLA,
// which fuses it into a few programs. Written with PyTorch operations,
// each of the 40 iterations is some hundred small launches (centring, the
// 3x3 cross-covariance, an SVD, the determinant sign, three 3x3 products,
// scale and translation), and torch.linalg.svd and det wait for the host
// on CUDA, so a CUDA graph cannot hold them. Here each frame's whole solve
// runs in one thread, in registers, and a step of B frames is one launch.
//
// What bounds it: each frame is a chain of dependent float64 operations
// (about 1e4 of them, square roots and divisions among them), so one
// thread's latency and the launch set its time; the card's arithmetic
// rate is not approached. Tensor cores, TMA and wgmma have no use here:
// each iteration is a six-point problem.
//
// Arithmetic is float64 inside, float32 in and out. The Jacobi rotations
// below take their angles from the dot products of the cross-covariance's
// columns, whose condition is the square of the cross-covariance's;
// float64 keeps the smallest singular vector accurate for flat landmark
// sets, where float32 would not.
//
// Per frame, as the reference:
//   rays = K^-1 [u, v, 1];  depth = assumed_depth
//   40 times: lifted = rays * depth
//             umeyama(canonical -> lifted): means, H = sc^T dc, SVD of H,
//               rot = V diag(1, 1, d) U^T with d = det(U V^T),
//               scale = (s0 + s1 + d s2) / sum |sc|^2,
//               t = mu_d - scale rot mu_s
//             model = rot canonical + t / max(scale, 1e-6);  depth = model.z
//   center = mean(model)
// The SVD is a cyclic one-sided Jacobi on the columns of H: rotations of
// column pairs until all are orthogonal (at most kMaxSweeps sweeps), warm
// started from the previous iteration's V, which the iterations barely
// move. Then U's first two columns are the normalized columns of H V and
// the third their cross product. The rotation above does not depend on
// the SVD's sign choices when the singular values are distinct, so it
// equals the reference's by value.
//
// Degenerate landmarks (RMS spread of the lifted points below 1e-6 of
// their distance, e.g. six landmarks at one pixel): the iteration takes
// the identity rotation and scale 0 and keeps the depths, as the plain
// version does (focus/geometry.py explains why).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPoints = 6;
constexpr int kMaxSweeps = 12;
constexpr double kDegenerateSpread = 1e-6;  // DEGENERATE_SPREAD in focus/geometry.py

__host__ __device__ inline double dot3(const double a[3], const double b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// One Jacobi rotation of columns p and q of m (3x3, columns m[.][p]) and of v,
// making the two columns of m orthogonal. Returns false if they already were.
__host__ __device__ inline bool rotate_pair(double m[3][3], double v[3][3], int p, int q) {
  double alpha = 0.0, beta = 0.0, gamma = 0.0;
  for (int k = 0; k < 3; ++k) {
    alpha += m[k][p] * m[k][p];
    beta += m[k][q] * m[k][q];
    gamma += m[k][p] * m[k][q];
  }
  if (gamma == 0.0 || fabs(gamma) <= 1e-15 * sqrt(alpha * beta)) return false;
  double zeta = (beta - alpha) / (2.0 * gamma);
  double t = (zeta >= 0.0 ? 1.0 : -1.0) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
  double c = 1.0 / sqrt(1.0 + t * t);
  double s = c * t;
  for (int k = 0; k < 3; ++k) {
    double mp = m[k][p], mq = m[k][q];
    m[k][p] = c * mp - s * mq;
    m[k][q] = s * mp + c * mq;
    double vp = v[k][p], vq = v[k][q];
    v[k][p] = c * vp - s * vq;
    v[k][q] = s * vp + c * vq;
  }
  return true;
}

__host__ __device__ inline void swap_cols(double a[3][3], int p, int q) {
  for (int k = 0; k < 3; ++k) {
    double t = a[k][p];
    a[k][p] = a[k][q];
    a[k][q] = t;
  }
}

__host__ __device__ inline void cross3(const double a[3], const double b[3], double out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// The proper rotation and similarity numerator of the Procrustes step.
// h: the 3x3 cross-covariance; v: the previous V (warm start), updated.
// Writes rot = V diag(1, 1, d) U^T and returns s0 + s1 + d s2.
// Adds the sweeps it took to *sweeps.
__host__ __device__ inline double svd_rotation(const double h[3][3], double v[3][3],
                                               double rot[3][3], int* sweeps) {
  double m[3][3];  // m = h v: its columns become U S
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      m[i][j] = h[i][0] * v[0][j] + h[i][1] * v[1][j] + h[i][2] * v[2][j];
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool moved = rotate_pair(m, v, 0, 1);
    moved = rotate_pair(m, v, 0, 2) || moved;
    moved = rotate_pair(m, v, 1, 2) || moved;
    ++*sweeps;
    if (!moved) break;
  }
  // singular values are the column norms; order them descending
  double n[3];
  for (int j = 0; j < 3; ++j) n[j] = m[0][j] * m[0][j] + m[1][j] * m[1][j] + m[2][j] * m[2][j];
  if (n[0] < n[1]) { swap_cols(m, 0, 1); swap_cols(v, 0, 1); double t = n[0]; n[0] = n[1]; n[1] = t; }
  if (n[0] < n[2]) { swap_cols(m, 0, 2); swap_cols(v, 0, 2); double t = n[0]; n[0] = n[2]; n[2] = t; }
  if (n[1] < n[2]) { swap_cols(m, 1, 2); swap_cols(v, 1, 2); double t = n[1]; n[1] = n[2]; n[2] = t; }

  // U's columns: u0 = c0 / s0, u1 the unit part of c1 orthogonal to u0,
  // u2 = u0 x u1 (so det U = +1); U = V when h == 0
  double c0[3] = {m[0][0], m[1][0], m[2][0]};
  double c1[3] = {m[0][1], m[1][1], m[2][1]};
  double c2[3] = {m[0][2], m[1][2], m[2][2]};
  double v0[3] = {v[0][0], v[1][0], v[2][0]};
  double v1[3] = {v[0][1], v[1][1], v[2][1]};
  double v2[3] = {v[0][2], v[1][2], v[2][2]};
  double u0[3], u1[3], u2[3], w[3];
  double s0 = sqrt(n[0]);
  if (s0 > 0.0) {
    for (int k = 0; k < 3; ++k) u0[k] = c0[k] / s0;
    double p = dot3(u0, c1);
    for (int k = 0; k < 3; ++k) w[k] = c1[k] - p * u0[k];
    double wn = sqrt(dot3(w, w));
    if (!(wn > 1e-12 * s0)) {  // rank 1: any unit vector orthogonal to u0
      int a = fabs(u0[0]) <= fabs(u0[1]) ? (fabs(u0[0]) <= fabs(u0[2]) ? 0 : 2)
                                          : (fabs(u0[1]) <= fabs(u0[2]) ? 1 : 2);
      double e[3] = {0.0, 0.0, 0.0};
      e[a] = 1.0;
      cross3(u0, e, w);
      wn = sqrt(dot3(w, w));
    }
    for (int k = 0; k < 3; ++k) u1[k] = w[k] / wn;
    cross3(u0, u1, u2);
  } else {
    for (int k = 0; k < 3; ++k) { u0[k] = v0[k]; u1[k] = v1[k]; u2[k] = v2[k]; }
  }
  // d = sign(det(U V^T)) = sign(det U det V)
  cross3(u0, u1, w);
  double det_u = dot3(w, u2);
  cross3(v0, v1, w);
  double d = det_u * dot3(w, v2) >= 0.0 ? 1.0 : -1.0;
  double u[3][3] = {{u0[0], u1[0], u2[0]}, {u0[1], u1[1], u2[1]}, {u0[2], u1[2], u2[2]}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      rot[i][j] = v[i][0] * u[j][0] + v[i][1] * u[j][1] + d * v[i][2] * u[j][2];
  // trace(diag(1, 1, d) U^T H V) = u0.c0 + u1.c1 + d u2.c2: the reference's
  // s0 + s1 + d s2 with the sign of u2 folded in
  return dot3(u0, c0) + dot3(u1, c1) + d * dot3(u2, c2);
}

// One frame's solve. lm: 6x2 pixels; k: 3x3 intrinsics; model: 6x3
// canonical face. Writes rot (3x3) and center (3); returns the Jacobi
// sweeps taken over all iterations.
__host__ __device__ inline int solve_frame(const float* lm, const float* k, const float* model,
                                           float assumed_depth, int iters, float* rot_out,
                                           float* center_out) {
  // K^-1 of an upper-triangular intrinsics matrix, in closed form
  double fx = k[0], sk = k[1], cx = k[2], fy = k[4], cy = k[5];
  double ki00 = 1.0 / fx, ki01 = -sk / (fx * fy), ki02 = (sk * cy - cx * fy) / (fx * fy);
  double ki11 = 1.0 / fy, ki12 = -cy / fy;
  double ray[kPoints][3], src[kPoints][3], depth[kPoints];
  double mu_s[3] = {0.0, 0.0, 0.0};
  for (int i = 0; i < kPoints; ++i) {
    double x = lm[2 * i], y = lm[2 * i + 1];
    ray[i][0] = ki00 * x + ki01 * y + ki02;
    ray[i][1] = ki11 * y + ki12;
    ray[i][2] = 1.0;
    depth[i] = assumed_depth;
    for (int a = 0; a < 3; ++a) mu_s[a] += model[3 * i + a];
  }
  double ss = 0.0;
  for (int a = 0; a < 3; ++a) mu_s[a] /= kPoints;
  for (int i = 0; i < kPoints; ++i)
    for (int a = 0; a < 3; ++a) {
      src[i][a] = model[3 * i + a] - mu_s[a];
      ss += src[i][a] * src[i][a];
    }
  ss = ss > 1e-12 ? ss : 1e-12;

  double v[3][3] = {{1.0, 0.0, 0.0}, {0.0, 1.0, 0.0}, {0.0, 0.0, 1.0}};
  double rot[3][3], center[3];
  int sweeps = 0;
  for (int it = 0; it < iters; ++it) {
    double p[kPoints][3], mu_d[3] = {0.0, 0.0, 0.0};
    for (int i = 0; i < kPoints; ++i)
      for (int a = 0; a < 3; ++a) {
        p[i][a] = ray[i][a] * depth[i];
        mu_d[a] += p[i][a];
      }
    for (int a = 0; a < 3; ++a) mu_d[a] /= kPoints;
    double h[3][3] = {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}};
    double spread = 0.0;
    for (int i = 0; i < kPoints; ++i) {
      double dc[3];
      for (int a = 0; a < 3; ++a) {
        dc[a] = p[i][a] - mu_d[a];
        spread += dc[a] * dc[a];
      }
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b) h[a][b] += src[i][a] * dc[b];
    }
    bool degenerate =
        spread <= kDegenerateSpread * kDegenerateSpread * kPoints * dot3(mu_d, mu_d);
    double scale;
    if (degenerate) {
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) rot[i][j] = i == j ? 1.0 : 0.0;
      scale = 0.0;
    } else {
      scale = svd_rotation(h, v, rot, &sweeps) / ss;
    }
    double t[3];
    for (int a = 0; a < 3; ++a)
      t[a] = mu_d[a] - scale * (rot[a][0] * mu_s[0] + rot[a][1] * mu_s[1] + rot[a][2] * mu_s[2]);
    double inv = 1.0 / (scale > 1e-6 ? scale : 1e-6);
    for (int a = 0; a < 3; ++a) center[a] = 0.0;
    for (int i = 0; i < kPoints; ++i) {
      double mc[3];
      for (int a = 0; a < 3; ++a)
        mc[a] = rot[a][0] * model[3 * i] + rot[a][1] * model[3 * i + 1] +
                rot[a][2] * model[3 * i + 2] + t[a] * inv;
      if (!degenerate) depth[i] = mc[2];
      for (int a = 0; a < 3; ++a) center[a] += mc[a];
    }
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) rot_out[3 * i + j] = static_cast<float>(rot[i][j]);
    center_out[i] = static_cast<float>(center[i] / kPoints);
  }
  return sweeps;
}

#ifdef __CUDACC__
__global__ void head_pose_kernel(const float* __restrict__ landmarks, const float* __restrict__ k,
                                 const float* __restrict__ model, float* __restrict__ rot,
                                 float* __restrict__ center, int* __restrict__ sweeps, int batch,
                                 float assumed_depth, int iters) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  int n = solve_frame(landmarks + 12 * b, k, model, assumed_depth, iters, rot + 9 * b,
                      center + 3 * b);
  if (sweeps != nullptr) sweeps[b] = n;
}
#endif

}  // namespace

#ifdef __CUDACC__
constexpr int kThreads = 64;

// landmarks (batch, 6, 2), k (3, 3), model (6, 3) float32 on the device;
// rot (batch, 3, 3) and center (batch, 3) float32 out; sweeps (batch,)
// int32 out, or null. Launches on `stream` and returns cudaGetLastError().
extern "C" int head_pose_from_landmarks(const void* landmarks, const void* k, const void* model,
                                        void* rot, void* center, void* sweeps, int batch,
                                        float assumed_depth, int iters, void* stream) {
  int blocks = (batch + kThreads - 1) / kThreads;
  head_pose_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(landmarks), static_cast<const float*>(k),
      static_cast<const float*>(model), static_cast<float*>(rot), static_cast<float*>(center),
      static_cast<int*>(sweeps), batch, assumed_depth, iters);
  return static_cast<int>(cudaGetLastError());
}
#endif
