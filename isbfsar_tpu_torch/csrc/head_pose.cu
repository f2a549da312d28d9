// The focus geometry of one frame from its six face landmarks, one thread
// per frame, for sm_90a: the 40-iteration weak-perspective PnP of
// isbfsar_tpu/focus/geometry.py::head_pose_from_landmarks, then, in the
// same launch, the functions the focus step applies to its result:
// rotmat_to_rotvec(rot), normalization_camera(center, K) and
// rotmat_to_rotvec(r_norm rot)[:2].
//
// It replaces no Pallas kernel: the JAX package leaves this to XLA, which
// fuses it into a few programs. Written with PyTorch operations, each of
// the 40 iterations is some hundred small launches, torch.linalg.svd and
// det wait for the host on CUDA, so no CUDA graph holds them, and the
// geometry after the solve is some 300 more launches. Here each frame's
// whole chain runs in one thread, in registers, and a step of B frames is
// one launch.
//
// What bounds it: each frame is one chain of dependent float64 operations,
// 40 iterations long, so one thread's latency and the launch set its time;
// the card's arithmetic rate is not approached. What the design does about
// it is to make the chain short. Each iteration solves its Procrustes step
// by QCP (Theobald 2005; Liu, Agrafiotis and Theobald 2010), not by an SVD:
// the proper rotation that best maps the centred model sc onto the centred
// lifted points dc is the quaternion of the largest eigenvalue of Horn's
// symmetric, traceless 4x4 matrix N(H), H = sum sc dc^T, and that
// eigenvalue is the reference's similarity numerator s0 + s1 + d s2,
// reflection correction included. The eigenvalue is the largest root of
// N's characteristic quartic x^4 + c2 x^2 + c1 x + c0 (c2 = -2 |H|_F^2,
// c1 = -8 det H, c0 = det N, in closed form from H), found by Newton from
// the Cauchy-Schwarz bound sqrt(|sc|^2 |dc|^2), which lies above it, so
// the steps fall monotonically onto it (a handful per iteration, at most
// kMaxNewton). The quaternion is the column of the adjugate of N - x I
// with the largest norm (the adjugate of a rank-3 symmetric matrix is
// rank 1, its columns multiples of the null vector), and the rotation is
// the quaternion's, divided by its squared norm. An iteration then has a
// few reciprocals in its chain (one per Newton step, the rotation's, the
// metric translation's) where a Jacobi SVD had some 36 square roots and
// divisions in series, and each is the card's approximate reciprocal,
// refined where the result must be exact to float64 (a Newton step need
// not be: the root does not depend on it); a float64 division costs
// several times as long. Sums over the six points are taken as trees,
// since the compiler keeps the order of float additions as written.
// Tensor cores, TMA and wgmma have no use here: each iteration is a
// six-point problem. With one thread per frame a warp issues every float64
// instruction of the chain, so the instruction count, and not only the
// chain's length, sets the time.
//
// Arithmetic is float64 inside, float32 in and out. The adjugate's
// entries are differences of products of nearly equal size at the
// eigenvalue (N - x I is singular there), and Newton's last steps resolve
// the eigenvalue to a relative 1e-11 out of terms of size x^4; float32
// would lose the rotation in both.
//
// Per frame, as the reference:
//   rays = K^-1 [u, v, 1];  depth = assumed_depth
//   40 times: lifted = rays * depth
//             umeyama(canonical -> lifted): means, H, the QCP rotation,
//               scale = x / sum |sc|^2, t = mu_d - scale rot mu_s
//             model = rot canonical + t / max(scale, 1e-6);  depth = model.z
//   center = mean(model) = rot mu_s + t / max(scale, 1e-6)
// then rotvec = log(rot), r_norm = rows (x, y, z) of the camera looking at
// center with y down, warp = K r_norm^T diag(s, s, 1) cam_norm^-1 over its
// [2][2] entry, which is normalization_camera's inverse in closed form
// (s = norm_distance / |center|, cam_norm = [[f, 0, c], [0, f, c],
// [0, 0, 1]]), and rot2d = log(r_norm rot)[:2].
//
// Degenerate landmarks (RMS spread of the lifted points below 1e-6 of
// their distance, e.g. six landmarks at one pixel): the iteration takes
// the identity rotation and scale 0 and keeps the depths, as the plain
// version does (focus/geometry.py explains why), and takes no Newton step.
//
// Without nvcc (__CUDACC__ undefined) the file is plain C++: a host
// compiler builds the same arithmetic (tests/test_torch_head_pose_host.py).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#define __host__
#define __device__
#endif
#include <math.h>

namespace {

constexpr int kPoints = 6;
constexpr double kInvPoints = 1.0 / kPoints;
constexpr int kMaxNewton = 16;
constexpr double kNewtonTol = 1e-11;  // relative size of the last Newton step
constexpr double kDegenerateSpread = 1e-6;  // DEGENERATE_SPREAD in focus/geometry.py

__host__ __device__ inline double sum6(const double v[kPoints]) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + (v[4] + v[5]);
}

__host__ __device__ inline double sq3(const double v[3]) {
  return v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
}

__host__ __device__ inline double rsqrt_(double x) {
#ifdef __CUDA_ARCH__
  return rsqrt(x);
#else
  return 1.0 / sqrt(x);
#endif
}

// 1 / x: the card's approximate reciprocal (rcp.approx.ftz.f64, good to
// about 2^-20), refined by `refine` Newton steps r (2 - x r), each of which
// doubles its correct bits; on the host, a division.
template <int refine>
__host__ __device__ inline double reciprocal(double x) {
#ifdef __CUDA_ARCH__
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
#pragma unroll
  for (int i = 0; i < refine; ++i) r = r * fma(-x, r, 2.0);
  return r;
#else
  return 1.0 / x;
#endif
}

// The largest root of x^4 + c2 x^2 + c1 x + c0, all of whose roots are
// real, by Newton from x above it. Adds the steps to *steps and keeps the
// most one call took in *most. A step divides by the derivative only
// approximately: the root, where the step vanishes, does not depend on it,
// and a step within 2^-20 of Newton's converges as fast.
__host__ __device__ inline double largest_root(double c2, double c1, double c0, double x,
                                               int* steps, int* most) {
  int n = 0;
  while (n < kMaxNewton) {
    double x2 = x * x;
    double b = (x2 + c2) * x;
    double a = b + c1;
    double step = (a * x + c0) * reciprocal<0>(2.0 * x2 * x + b + a);
    x -= step;
    ++n;
    if (fabs(step) <= kNewtonTol * fabs(x)) break;
  }
  *steps += n;
  if (n > *most) *most = n;
  return x;
}

// The proper rotation rot maximising trace(rot H) = sum dc.(rot sc), for the
// 3x3 cross-covariance h = sum sc dc^T, and that maximum; x0 is an upper
// bound of it.
__host__ __device__ inline double qcp_rotation(const double h[3][3], double x0, double rot[3][3],
                                               int* steps, int* most) {
  double sxx = h[0][0], sxy = h[0][1], sxz = h[0][2];
  double syx = h[1][0], syy = h[1][1], syz = h[1][2];
  double szx = h[2][0], szy = h[2][1], szz = h[2][2];
  double sxx2 = sxx * sxx, syy2 = syy * syy, szz2 = szz * szz;
  double sxy2 = sxy * sxy, syz2 = syz * syz, sxz2 = sxz * sxz;
  double syx2 = syx * syx, szy2 = szy * szy, szx2 = szx * szx;
  double c2 = -2.0 * (((sxx2 + syy2) + (szz2 + sxy2)) + ((syx2 + sxz2) + (szx2 + (syz2 + szy2))));
  double c1 = 8.0 * (((sxx * syz * szy + syy * szx * sxz) + (szz * sxy * syx - sxx * syy * szz)) -
                     (syz * szx * sxy + szy * syx * sxz));
  // c0 = det N, Theobald's closed form
  double sxzpszx = sxz + szx, syzpszy = syz + szy, sxypsyx = sxy + syx;
  double syzmszy = syz - szy, sxzmszx = sxz - szx, sxymsyx = sxy - syx;
  double sxxpsyy = sxx + syy, sxxmsyy = sxx - syy;
  double d1 = (sxy2 + sxz2) - (syx2 + szx2);
  double e1 = ((syy2 + szz2) - sxx2) + (syz2 + szy2);
  double e2 = 2.0 * (syz * szy - syy * szz);
  double c0 = ((d1 * d1 + (e1 + e2) * (e1 - e2)) +
               ((-sxzpszx * syzmszy + sxymsyx * (sxxmsyy - szz)) *
                    (-sxzmszx * syzpszy + sxymsyx * (sxxmsyy + szz)) +
                (-sxzpszx * syzpszy - sxypsyx * (sxxpsyy - szz)) *
                    (-sxzmszx * syzmszy - sxypsyx * (sxxpsyy + szz)))) +
              ((sxypsyx * syzpszy + sxzpszx * (sxxmsyy + szz)) *
                   (-sxymsyx * syzmszy + sxzpszx * (sxxpsyy + szz)) +
               (sxypsyx * syzmszy + sxzmszx * (sxxmsyy - szz)) *
                   (-sxymsyx * syzpszy + sxzmszx * (sxxpsyy - szz)));
  double x = largest_root(c2, c1, c0, x0, steps, most);

  // a = N - x I (Horn's N, rows and columns w, x, y, z of the quaternion)
  double a[4][4] = {
      {sxxpsyy + szz - x, syzmszy, -sxzmszx, sxymsyx},
      {syzmszy, sxxmsyy - szz - x, sxypsyx, sxzpszx},
      {-sxzmszx, sxypsyx, syy - sxx - szz - x, syzpszy},
      {sxymsyx, sxzpszx, syzpszy, szz - sxxpsyy - x},
  };
  // its adjugate, from the 2x2 minors of rows 0-1 (s) and rows 2-3 (c)
  double s0 = a[0][0] * a[1][1] - a[1][0] * a[0][1], s1 = a[0][0] * a[1][2] - a[1][0] * a[0][2];
  double s2 = a[0][0] * a[1][3] - a[1][0] * a[0][3], s3 = a[0][1] * a[1][2] - a[1][1] * a[0][2];
  double s4 = a[0][1] * a[1][3] - a[1][1] * a[0][3], s5 = a[0][2] * a[1][3] - a[1][2] * a[0][3];
  double k0 = a[2][0] * a[3][1] - a[3][0] * a[2][1], k1 = a[2][0] * a[3][2] - a[3][0] * a[2][2];
  double k2 = a[2][0] * a[3][3] - a[3][0] * a[2][3], k3 = a[2][1] * a[3][2] - a[3][1] * a[2][2];
  double k4 = a[2][1] * a[3][3] - a[3][1] * a[2][3], k5 = a[2][2] * a[3][3] - a[3][2] * a[2][3];
  double adj[4][4] = {
      {a[1][1] * k5 - a[1][2] * k4 + a[1][3] * k3, -a[0][1] * k5 + a[0][2] * k4 - a[0][3] * k3,
       a[3][1] * s5 - a[3][2] * s4 + a[3][3] * s3, -a[2][1] * s5 + a[2][2] * s4 - a[2][3] * s3},
      {-a[1][0] * k5 + a[1][2] * k2 - a[1][3] * k1, a[0][0] * k5 - a[0][2] * k2 + a[0][3] * k1,
       -a[3][0] * s5 + a[3][2] * s2 - a[3][3] * s1, a[2][0] * s5 - a[2][2] * s2 + a[2][3] * s1},
      {a[1][0] * k4 - a[1][1] * k2 + a[1][3] * k0, -a[0][0] * k4 + a[0][1] * k2 - a[0][3] * k0,
       a[3][0] * s4 - a[3][1] * s2 + a[3][3] * s0, -a[2][0] * s4 + a[2][1] * s2 - a[2][3] * s0},
      {-a[1][0] * k3 + a[1][1] * k1 - a[1][2] * k0, a[0][0] * k3 - a[0][1] * k1 + a[0][2] * k0,
       -a[3][0] * s3 + a[3][1] * s1 - a[3][2] * s0, a[2][0] * s3 - a[2][1] * s1 + a[2][2] * s0},
  };
  // the column of largest norm, chosen without indexing by a runtime value
  // (which would put adj in local memory)
  double q[4], qq = -1.0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    double n = (adj[0][j] * adj[0][j] + adj[1][j] * adj[1][j]) +
               (adj[2][j] * adj[2][j] + adj[3][j] * adj[3][j]);
    if (n > qq) {
      qq = n;
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = adj[i][j];
    }
  }
  if (!(qq > 1e-280)) {  // no null vector resolved (H = 0): the identity
    q[0] = 1.0;
    q[1] = q[2] = q[3] = 0.0;
    qq = 1.0;
  }
  // rot of the quaternion (w, x, y, z) = q / |q|: every entry is quadratic
  // in q, so one division by |q|^2 normalises it
  double inv = reciprocal<2>(qq);
  double w = q[0], qx = q[1], qy = q[2], qz = q[3];
  double ww = w * w, xx = qx * qx, yy = qy * qy, zz = qz * qz;
  double xy = qx * qy, xz = qx * qz, yz = qy * qz, wx = w * qx, wy = w * qy, wz = w * qz;
  rot[0][0] = ((ww + xx) - (yy + zz)) * inv;
  rot[0][1] = 2.0 * (xy - wz) * inv;
  rot[0][2] = 2.0 * (xz + wy) * inv;
  rot[1][0] = 2.0 * (xy + wz) * inv;
  rot[1][1] = ((ww - xx) + (yy - zz)) * inv;
  rot[1][2] = 2.0 * (yz - wx) * inv;
  rot[2][0] = 2.0 * (xz - wy) * inv;
  rot[2][1] = 2.0 * (yz + wx) * inv;
  rot[2][2] = ((ww - xx) - (yy - zz)) * inv;
  return x;
}

// SO(3) log map of r with both branches of focus/geometry.py::rotmat_to_rotvec:
// the antisymmetric part, and near pi the column of (r + I) / 2 with the
// largest diagonal entry (the first on ties, as argmax).
__host__ __device__ inline void rotvec_of(const double r[3][3], double out[3]) {
  double cos_a = ((r[0][0] + r[1][1] + r[2][2]) - 1.0) * 0.5;
  cos_a = cos_a < -1.0 ? -1.0 : (cos_a > 1.0 ? 1.0 : cos_a);
  double angle = acos(cos_a);
  if (cos_a < -1.0 + 1e-4) {
    double b0 = (r[0][0] + 1.0) * 0.5, b1 = (r[1][1] + 1.0) * 0.5, b2 = (r[2][2] + 1.0) * 0.5;
    double col[3];
    if (b0 >= b1 && b0 >= b2) {
      col[0] = b0; col[1] = r[1][0] * 0.5; col[2] = r[2][0] * 0.5;
    } else if (b1 >= b2) {
      col[0] = r[0][1] * 0.5; col[1] = b1; col[2] = r[2][1] * 0.5;
    } else {
      col[0] = r[0][2] * 0.5; col[1] = r[1][2] * 0.5; col[2] = b2;
    }
    double s = angle / (sqrt(sq3(col)) + 1e-12);
    for (int a = 0; a < 3; ++a) out[a] = col[a] * s;
    return;
  }
  double sin_a = sin(angle);
  double s = fabs(sin_a) > 1e-6 ? angle / (2.0 * sin_a + 1e-12) : 0.5;
  out[0] = (r[2][1] - r[1][2]) * s;
  out[1] = (r[0][2] - r[2][0]) * s;
  out[2] = (r[1][0] - r[0][1]) * s;
}

// One frame. lm: 6x2 pixels; k: 3x3 upper-triangular intrinsics; model:
// 6x3 canonical face; focal and half_size: the normalized camera's focal
// length and principal point. Writes rot (3x3), center (3), rotvec (3),
// warp (3x3), r_norm (3x3) and rot2d (2); returns the Newton steps taken
// over all iterations and keeps the most of one iteration in *most.
__host__ __device__ inline int focus_frame(const float* lm, const float* k, const float* model,
                                           float assumed_depth, float norm_distance, float focal,
                                           float half_size, int iters, float* rot_out,
                                           float* center_out, float* rotvec_out, float* warp_out,
                                           float* r_norm_out, float* rot2d_out, int* most) {
  // K^-1 of an upper-triangular intrinsics matrix, in closed form
  double fx = k[0], sk = k[1], cx = k[2], fy = k[4], cy = k[5];
  double ki00 = 1.0 / fx, ki01 = -sk / (fx * fy), ki02 = (sk * cy - cx * fy) / (fx * fy);
  double ki11 = 1.0 / fy, ki12 = -cy / fy;
  double ray[kPoints][2], src[kPoints][3], depth[kPoints], mu_s[3], col[kPoints];
#pragma unroll
  for (int i = 0; i < kPoints; ++i) {
    double x = lm[2 * i], y = lm[2 * i + 1];
    ray[i][0] = ki00 * x + ki01 * y + ki02;
    ray[i][1] = ki11 * y + ki12;  // ray z is 1
    depth[i] = assumed_depth;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int i = 0; i < kPoints; ++i) col[i] = model[3 * i + a];
    mu_s[a] = sum6(col) * kInvPoints;
#pragma unroll
    for (int i = 0; i < kPoints; ++i) src[i][a] = model[3 * i + a] - mu_s[a];
  }
#pragma unroll
  for (int i = 0; i < kPoints; ++i) col[i] = sq3(src[i]);
  double ss = sum6(col);
  ss = ss > 1e-12 ? ss : 1e-12;
  double inv_ss = 1.0 / ss;

  double rot[3][3], t_metric[3];
  int steps = 0;
  *most = 0;
  for (int it = 0; it < iters; ++it) {
    double p[kPoints][3], mu_d[3], dc[kPoints][3];
#pragma unroll
    for (int i = 0; i < kPoints; ++i) {
      p[i][0] = ray[i][0] * depth[i];
      p[i][1] = ray[i][1] * depth[i];
      p[i][2] = depth[i];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int i = 0; i < kPoints; ++i) col[i] = p[i][a];
      mu_d[a] = sum6(col) * kInvPoints;
#pragma unroll
      for (int i = 0; i < kPoints; ++i) dc[i][a] = p[i][a] - mu_d[a];
    }
#pragma unroll
    for (int i = 0; i < kPoints; ++i) col[i] = sq3(dc[i]);
    double spread = sum6(col);
    double dist = sq3(mu_d);
    bool degenerate = spread <= kDegenerateSpread * kDegenerateSpread * kPoints * dist;
    double scale;
    if (degenerate) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) rot[i][j] = i == j ? 1.0 : 0.0;
      scale = 0.0;
    } else {
      double h[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
#pragma unroll
          for (int i = 0; i < kPoints; ++i) col[i] = src[i][a] * dc[i][b];
          h[a][b] = sum6(col);
        }
      scale = qcp_rotation(h, sqrt(ss * spread), rot, &steps, most) * inv_ss;
    }
    double inv = reciprocal<2>(scale > 1e-6 ? scale : 1e-6);
#pragma unroll
    for (int a = 0; a < 3; ++a)
      t_metric[a] = (mu_d[a] - scale * (rot[a][0] * mu_s[0] + rot[a][1] * mu_s[1] +
                                        rot[a][2] * mu_s[2])) * inv;
    if (!degenerate) {  // depth = model.z = rot[2].(sc + mu_s) + t_metric.z
      double z0 = rot[2][0] * mu_s[0] + rot[2][1] * mu_s[1] + rot[2][2] * mu_s[2] + t_metric[2];
#pragma unroll
      for (int i = 0; i < kPoints; ++i)
        depth[i] = rot[2][0] * src[i][0] + rot[2][1] * src[i][1] + rot[2][2] * src[i][2] + z0;
    }
  }
  double center[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    center[a] = rot[a][0] * mu_s[0] + rot[a][1] * mu_s[1] + rot[a][2] * mu_s[2] + t_metric[a];

  // the normalizing camera: z toward the face, x = (0, 1, 0) x z, y = z x x
  double inv_c = rsqrt_(sq3(center));
  double rn[3][3];
  rn[2][0] = center[0] * inv_c;
  rn[2][1] = center[1] * inv_c;
  rn[2][2] = center[2] * inv_c;
  double inv_x = rsqrt_(rn[2][2] * rn[2][2] + rn[2][0] * rn[2][0]);
  rn[0][0] = rn[2][2] * inv_x;
  rn[0][1] = 0.0;
  rn[0][2] = -rn[2][0] * inv_x;
  rn[1][0] = rn[2][1] * rn[0][2] - rn[2][2] * rn[0][1];
  rn[1][1] = rn[2][2] * rn[0][0] - rn[2][0] * rn[0][2];
  rn[1][2] = rn[2][0] * rn[0][1] - rn[2][1] * rn[0][0];
  // warp = K P over its [2][2] entry, P = r_norm^T diag(s, s, 1) cam_norm^-1:
  // P's columns are (s/f) x, (s/f) y and z - (s c/f)(x + y)
  double sf = norm_distance * inv_c / focal;
  double pm[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pm[i][0] = sf * rn[0][i];
    pm[i][1] = sf * rn[1][i];
    pm[i][2] = rn[2][i] - sf * half_size * (rn[0][i] + rn[1][i]);
  }
  double wm[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    wm[0][j] = fx * pm[0][j] + sk * pm[1][j] + cx * pm[2][j];
    wm[1][j] = fy * pm[1][j] + cy * pm[2][j];
    wm[2][j] = pm[2][j];
  }
  double inv_w = 1.0 / wm[2][2];
  double rr[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      rr[i][j] = rn[i][0] * rot[0][j] + rn[i][1] * rot[1][j] + rn[i][2] * rot[2][j];
  double rv[3], rv2[3];
  rotvec_of(rot, rv);
  rotvec_of(rr, rv2);

#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      rot_out[3 * i + j] = static_cast<float>(rot[i][j]);
      warp_out[3 * i + j] = static_cast<float>(wm[i][j] * inv_w);
      r_norm_out[3 * i + j] = static_cast<float>(rn[i][j]);
    }
    center_out[i] = static_cast<float>(center[i]);
    rotvec_out[i] = static_cast<float>(rv[i]);
  }
  rot2d_out[0] = static_cast<float>(rv2[0]);
  rot2d_out[1] = static_cast<float>(rv2[1]);
  return steps;
}

#ifdef __CUDACC__
__global__ void focus_geometry_kernel(const float* __restrict__ landmarks,
                                      const float* __restrict__ k, const float* __restrict__ model,
                                      float* __restrict__ rot, float* __restrict__ center,
                                      float* __restrict__ rotvec, float* __restrict__ warp,
                                      float* __restrict__ r_norm, float* __restrict__ rot2d,
                                      int* __restrict__ steps, int batch, float assumed_depth,
                                      float norm_distance, float focal, float half_size,
                                      int iters) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  int most;
  int n = focus_frame(landmarks + 12 * b, k, model, assumed_depth, norm_distance, focal,
                      half_size, iters, rot + 9 * b, center + 3 * b, rotvec + 3 * b, warp + 9 * b,
                      r_norm + 9 * b, rot2d + 2 * b, &most);
  if (steps != nullptr) {
    steps[2 * b] = n;
    steps[2 * b + 1] = most;
  }
}
#endif

}  // namespace

#ifdef __CUDACC__
constexpr int kThreads = 64;

// landmarks (batch, 6, 2), k (3, 3), model (6, 3) float32 on the device;
// out: rot (batch, 3, 3), center (batch, 3), rotvec (batch, 3), warp
// (batch, 3, 3), r_norm (batch, 3, 3), rot2d (batch, 2) float32, and
// steps (batch, 2) int32 (the Newton steps over all iterations, the most
// in one) or null. Launches on `stream` and returns cudaGetLastError().
extern "C" int focus_geometry(const void* landmarks, const void* k, const void* model, void* rot,
                              void* center, void* rotvec, void* warp, void* r_norm, void* rot2d,
                              void* steps, int batch, float assumed_depth, float norm_distance,
                              float focal, float half_size, int iters, void* stream) {
  int blocks = (batch + kThreads - 1) / kThreads;
  focus_geometry_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(landmarks), static_cast<const float*>(k),
      static_cast<const float*>(model), static_cast<float*>(rot), static_cast<float*>(center),
      static_cast<float*>(rotvec), static_cast<float*>(warp), static_cast<float*>(r_norm),
      static_cast<float*>(rot2d), static_cast<int*>(steps), batch, assumed_depth, norm_distance,
      focal, half_size, iters);
  return static_cast<int>(cudaGetLastError());
}
#endif
